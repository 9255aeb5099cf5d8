"""The port's two-process run (the counterpart of tests/test_multihost.py):
two OS processes in a gloo group on 127.0.0.1, four CPU positions each, a
('host', 'chip') = (2, 4) mesh (tests/torch_mp_worker.py). The session
and the fleet must read back and decode only each process's own shards,
and telemetry and metrics must cross processes by the fan-in; the
time-sharded front end's halo crosses between the processes by send and
receive."""

import json
import os
import socket
import subprocess
import sys

import torch_cpu_threads  # noqa: F401  (one torch thread per worker)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mp_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_shard_readback_and_fanin():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), str(port),
                               "cpu"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO)
             for i in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            r = json.loads([ln for ln in out.splitlines()
                            if ln.startswith("{")][-1])
            results[r["rank"]] = r
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    assert results[0]["ranks"] == [[0, 0, 0, 0], [1, 1, 1, 1]]
    # each process decoded EXACTLY its own channel shards (4 of 8)
    assert results[0]["local_telemetry"] == [0, 1, 2, 3]
    assert results[1]["local_telemetry"] == [4, 5, 6, 7]
    for rank in (0, 1):
        r = results[rank]
        assert r["expected_local"] == r["local_telemetry"]
        # the all-gather fan-in shows every channel on BOTH processes
        assert r["fan_channels"] == list(range(8))
        assert abs(r["fan_lat0"] - 45.0) < 1e-3
        assert r["serial0"] == "S1234567"
        # summed metrics: both processes agree on the totals
        assert r["metrics"]["frames_decoded"] >= 8
    assert results[0]["metrics"] == results[1]["metrics"]

    # the fused mesh fleet: each process decodes only its shards of the
    # rs41 group, the fan-in sees all 8 on both; the PFB rows reach the
    # shards device to device, with no per-block host upload
    assert results[0]["fleet_local"] == [0, 1, 2, 3]
    assert results[1]["fleet_local"] == [4, 5, 6, 7]
    for rank in (0, 1):
        r = results[rank]
        assert r["fleet_fan"] == list(range(8))
        assert r["fleet_shard_stats"]["host_uploads"] == 0, r
        assert r["fleet_shard_stats"]["device_feeds"] > 0, r
        assert r["fleet_fused_mesh"] is True
        # the time-sharded front end across the two processes equals the
        # serial chain within tests/test_parallel.py's 2e-4
        assert r["time_parallel_shape"] == [4, 8192]
        assert r["time_parallel_err"] <= 2e-4
