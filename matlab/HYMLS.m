classdef HYMLS < handle
% HYMLS  MATLAB interface to the hymls preconditioner.
%
%   h = HYMLS(A, 'params.xml')   build the multilevel preconditioner
%                                for the sparse matrix A with the
%                                reference XML parameter file
%   y = h.apply(x)               y = P^{-1} x  (x may be a matrix of
%                                column vectors)
%   h.set_border(v)              add a border [K v; v' 0]
%   h.set_border(v, w)           add a border [K v; w' 0]
%   h.compute()                  re-factor (same sparsity pattern)
%   h.compute(A2)                re-factor with new values
%   delete(h)                    free the preconditioner
%
% Same calling convention as the reference MEX interface
% (reference matlab/HYMLS.m, matlab/HYMLS_init.cpp:14-91), but backed
% by a persistent Python server process (hymls.matlab_bridge) over
% a file-RPC protocol, so no MEX compilation is required.  Requires
% `python` with hymls importable on PYTHONPATH.

    properties
        dir        % session directory
        seq        % request sequence number
        n          % problem size
        alive
    end

    methods
        function h = HYMLS(A, params)
            if nargin ~= 2
                error('Two input arguments required');
            end
            h.dir = tempname;
            mkdir(h.dir);
            h.seq = 0;
            h.alive = false;
            hymls_mmwrite(fullfile(h.dir, 'A.mtx'), A);
            if exist(params, 'file')
                copyfile(params, fullfile(h.dir, 'params.xml'));
            else
                error('HYMLS: parameter file %s not found', params);
            end
            % start the server detached
            if ispc
                system(sprintf( ...
                    'start /b python -m hymls.matlab_bridge "%s"', ...
                    h.dir));
            else
                system(sprintf( ...
                    'python -m hymls.matlab_bridge "%s" >"%s" 2>&1 &', ...
                    h.dir, fullfile(h.dir, 'server.log')));
            end
            h.wait_for(fullfile(h.dir, 'server.ready'), 120);
            h.alive = true;
            resp = h.rpc(struct('cmd', 'init', 'matrix', 'A.mtx', ...
                                'params', 'params.xml'));
            h.n = resp.n;
        end

        function y = apply(h, x)
            if nargin ~= 2
                error('One input argument required');
            end
            xf = sprintf('x%d.mtx', h.seq);
            yf = sprintf('y%d.mtx', h.seq);
            hymls_mmwrite(fullfile(h.dir, xf), full(x));
            h.rpc(struct('cmd', 'apply', 'x', xf, 'y', yf));
            y = hymls_mmread(fullfile(h.dir, yf));
            if isvector(x)
                y = y(:);
            end
        end

        function set_border(h, v, w)
            vf = sprintf('v%d.mtx', h.seq);
            hymls_mmwrite(fullfile(h.dir, vf), full(v));
            req = struct('cmd', 'set_border', 'v', vf);
            if nargin == 3
                wf = sprintf('w%d.mtx', h.seq);
                hymls_mmwrite(fullfile(h.dir, wf), full(w));
                req.w = wf;
            elseif nargin ~= 2
                error('One or two input arguments required');
            end
            h.rpc(req);
        end

        function compute(h, A)
            req = struct('cmd', 'compute');
            if nargin == 2
                af = sprintf('A%d.mtx', h.seq);
                hymls_mmwrite(fullfile(h.dir, af), A);
                req.matrix = af;
            end
            h.rpc(req);
        end

        function delete(h)
            if h.alive
                try
                    h.rpc(struct('cmd', 'free'));
                catch
                end
                h.alive = false;
                fprintf('HYMLS successfully deleted\n');
            end
        end
    end

    methods (Access = private)
        function resp = rpc(h, req)
            base = fullfile(h.dir, sprintf('%d', h.seq));
            fid = fopen([base '.req.json'], 'w');
            fwrite(fid, jsonencode(req));
            fclose(fid);
            fclose(fopen([base '.req.done'], 'w'));
            h.wait_for([base '.resp.json'], 600);
            fid = fopen([base '.resp.json'], 'r');
            resp = jsondecode(fread(fid, inf, 'char=>char')');
            fclose(fid);
            h.seq = h.seq + 1;
            if ~resp.ok
                error('HYMLS bridge error: %s', resp.error);
            end
        end

        function wait_for(~, path, timeout_s)
            t0 = tic;
            while ~exist(path, 'file')
                if toc(t0) > timeout_s
                    error('HYMLS: timed out waiting for %s', path);
                end
                pause(0.02);
            end
        end
    end
end
