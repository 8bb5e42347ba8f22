"""Profiling scopes / function tracing / memory ledger
(reference HYMLS_PROF macros src/HYMLS_Macros.hpp:55-129, Tools timing
src/HYMLS_Tools.cpp:345-438, malloc ledger src/HYMLS_Malloc.cpp)."""
import _cpu  # noqa: F401

from hymls.utils import timings


def test_prof_scope_accumulates():
    with timings.prof("unit-test-scope", level=1):
        pass
    t = timings._prof_timer()
    assert t.count("unit-test-scope") >= 1
    assert "unit-test-scope" in timings.print_timing()


def test_prof_level_gating(monkeypatch):
    monkeypatch.setattr(timings, "TIMING_LEVEL", 1)
    monkeypatch.setattr(timings, "FUNCTION_TRACING", False)
    before = timings._prof_timer().count("gated-scope")
    with timings.prof("gated-scope", level=3):
        pass
    assert timings._prof_timer().count("gated-scope") == before


def test_function_tracing_prints(monkeypatch, capsys):
    monkeypatch.setattr(timings, "FUNCTION_TRACING", True)

    @timings.profiled("traced-fn", level=1)
    def f():
        return 7

    assert f() == 7
    err = capsys.readouterr().err
    assert ">> traced-fn" in err and "<< traced-fn" in err


def test_host_memory_ledger():
    timings.start_memory("phase-x")
    blob = bytearray(8 << 20)          # ~8 MB
    timings.stop_memory("phase-x")
    rep = timings.host_memory_report()
    assert "RSS" in rep and "phase-x" in rep
    del blob
