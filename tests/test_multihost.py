"""Multi-process (multi-host-shaped) validation of the sharded DPE step.

SURVEY §2.3 P7: the reference has NO distributed backend (an unimplemented
note at architecture.txt:92-101). Here, two OS processes — each owning 4
virtual CPU devices — form one 8-device (chan=2, grid=4) global mesh via
jax.distributed (Gloo collectives on CPU; the identical code uses NCCL
across GPUs), run the full sharded DPE step on identical inputs, and must
both report the argmax the single-process path produces.
"""

import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent("""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid, port = int(sys.argv[1]), int(sys.argv[2])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import __graft_entry__ as ge
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu.parallel import mesh as pmesh

devs = jax.devices()
m = pmesh.make_mesh(n_grid=4, n_chan=2, devices=devs)
grid = uniform_grid(n=8, pos_spacing=5.0, vel_spacing=0.5)
args, meta = ge._example_args(c=8, s=20000, grid=grid)
step = pmesh.sharded_dpe_step_real(m, **meta)
with m:
    out = step(*args)
    jax.block_until_ready(out)
print(f"RESULT pid={pid} ndev={len(devs)} nloc={len(jax.local_devices())} "
      f"pa={int(out[1])} va={int(out[3])}", flush=True)
""")


@pytest.mark.slow
def test_two_process_global_mesh_matches_single():
    # single-process reference on the same deterministic inputs
    import __graft_entry__ as ge
    from navlab_dpe_sdr_tpu.models.grid import uniform_grid
    from navlab_dpe_sdr_tpu.ops import dpe_real as dr
    import jax

    grid = uniform_grid(n=8, pos_spacing=5.0, vel_spacing=0.5)
    args, meta = ge._example_args(c=8, s=20000, grid=grid)
    out = dr.dpe_device_step_real(*args, **meta)
    jax.block_until_ready(out)
    want_pa, want_va = int(out[1]), int(out[3])

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    import os
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    results = {}
    for p in procs:
        out_b, _ = p.communicate(timeout=500)
        text = out_b.decode()
        assert p.returncode == 0, text[-2000:]
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT")][-1]
        kv = dict(tok.split("=") for tok in line.split()[1:])
        results[int(kv["pid"])] = kv

    for pid, kv in results.items():
        assert int(kv["ndev"]) == 8, kv        # global device view
        assert int(kv["nloc"]) == 4, kv        # ...but only 4 local
        assert int(kv["pa"]) == want_pa, (kv, want_pa)
        assert int(kv["va"]) == want_va, (kv, want_va)


@pytest.mark.slow
def test_two_process_launcher_end_to_end(tmp_path):
    """The multi-host launcher binary (parallel.launch) run as two real
    processes: each runs the identical host loop on its capture shard with
    grid scoring sharded over the 8-device global mesh; both must converge
    to the same fix near the true receiver position."""
    import os

    from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16
    from navlab_dpe_sdr_tpu.io.handoff import write_handoff
    from navlab_dpe_sdr_tpu.io.scenario import make_scenario

    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * 5
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    dat = str(tmp_path / "cap.dat")
    samples.tofile(dat)
    handoff_csv = str(tmp_path / "hand.csv")
    write_handoff(handoff_csv, hand)
    truth = hand.x_ecef[:3].copy()

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "navlab_dpe_sdr_tpu.parallel.launch",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--capture", dat, "--handoff", handoff_csv, "--blocks", "5",
           "--grid", "uniform", "--grid-n", "9", "--grid-spacing", "8.0"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for i in range(2)]
    fixes = {}
    for i, p in enumerate(procs):
        out_b, _ = p.communicate(timeout=500)
        text = out_b.decode()
        assert p.returncode == 0, text[-2000:]
        line = [ln for ln in text.splitlines() if "final fix" in ln][-1]
        fixes[i] = np.fromstring(line.split("[")[-1].rstrip("]"), sep=" ")

    np.testing.assert_allclose(fixes[0], fixes[1], atol=1e-6)
    assert np.linalg.norm(fixes[0] - truth) < 40.0, (fixes[0], truth)
