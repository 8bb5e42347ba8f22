"""Drive the MATLAB bridge server (hymls/matlab_bridge.py) through
its file-RPC protocol exactly as matlab/HYMLS.m does."""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import scipy.io as sio

from hymls.config import Params, save_xml
from hymls.stencils import create_matrix


def _wait(path, timeout=600):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.02)


class Client:
    """The matlab/HYMLS.m protocol, in Python."""

    def __init__(self, d):
        self.dir = d
        self.seq = 0

    def rpc(self, req):
        base = os.path.join(self.dir, str(self.seq))
        with open(base + ".req.json", "w") as f:
            json.dump(req, f)
        open(base + ".req.done", "w").close()
        _wait(base + ".resp.json")
        with open(base + ".resp.json") as f:
            resp = json.load(f)
        self.seq += 1
        assert resp["ok"], resp.get("error", "") + \
            "\n" + resp.get("traceback", "")
        return resp


@pytest.fixture(scope="module")
def bridge():
    d = tempfile.mkdtemp(prefix="hymls_bridge_")
    params = Params({
        "Problem": {"Equations": "Laplace", "Dimension": 2,
                    "nx": 16, "ny": 16},
        "Preconditioner": {"Separator Length": 4,
                           "Number of Levels": 1},
    })
    K = create_matrix(params)
    sio.mmwrite(os.path.join(d, "A.mtx"), K)
    save_xml(params, os.path.join(d, "params.xml"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "hymls.matlab_bridge", d],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        _wait(os.path.join(d, "server.ready"))
        yield Client(d), K, proc
    finally:
        if proc.poll() is None:
            proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.slow   # spawns a fresh-process bridge server (own XLA
#                     compiles, ~47 s on the 1-core CI host)
def test_bridge_init_apply_free(bridge):
    cli, K, proc = bridge
    resp = cli.rpc({"cmd": "init", "matrix": "A.mtx",
                    "params": "params.xml"})
    assert resp["n"] == K.shape[0]

    rng = np.random.default_rng(0)
    x = rng.standard_normal((K.shape[0], 2))
    sio.mmwrite(os.path.join(cli.dir, "x.mtx"), x)
    cli.rpc({"cmd": "apply", "x": "x.mtx", "y": "y.mtx"})
    y = np.asarray(sio.mmread(os.path.join(cli.dir, "y.mtx")))
    assert y.shape == x.shape
    # P^{-1} is a real preconditioner: K @ y ~ x to preconditioner
    # quality; with one level + small grid the residual must shrink
    r0 = np.linalg.norm(x, axis=0)
    r1 = np.linalg.norm(K @ y - x, axis=0)
    assert np.all(r1 < 0.7 * r0)

    # unknown command reports error but keeps serving
    base = os.path.join(cli.dir, str(cli.seq))
    with open(base + ".req.json", "w") as f:
        json.dump({"cmd": "nope"}, f)
    open(base + ".req.done", "w").close()
    _wait(base + ".resp.json")
    with open(base + ".resp.json") as f:
        resp = json.load(f)
    cli.seq += 1
    assert not resp["ok"]

    cli.rpc({"cmd": "compute"})
    cli.rpc({"cmd": "free"})
    proc.wait(timeout=60)
    assert proc.returncode == 0
