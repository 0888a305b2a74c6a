"""CLI smoke tests through real subprocesses (guards the wiring)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _run(*args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "navlab_dpe_sdr_tpu.cli", "--device", "cpu",
         *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


@pytest.fixture(scope="module")
def tiny_capture(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cap = d / "cap.dat"
    hand = d / "hand.csv"
    r = _run("synth", "--out", str(cap), "--handoff", str(hand),
             "--seconds", "1.2", "--cn0", "47")
    assert r.returncode == 0, r.stderr[-800:]
    return cap, hand


def test_cli_acquire(tiny_capture):
    cap, hand = tiny_capture
    r = _run("acquire", str(cap), "--prns", "2,7,6,12")
    assert r.returncode == 0, r.stderr[-800:]
    assert "True" in r.stdout


def test_cli_dpe_with_native_io(tiny_capture, tmp_path):
    cap, hand = tiny_capture
    fixes = tmp_path / "fixes.csv"
    xlog = tmp_path / "x.csv"
    r = _run("dpe", str(cap), "--handoff", str(hand), "--blocks", "20",
             "--out", str(fixes), "--native-io", "--xecef-log", str(xlog),
             "--watchdog", "600")
    assert r.returncode == 0, r.stderr[-800:]
    assert "final fix" in r.stdout
    rows = fixes.read_text().splitlines()
    assert len(rows) == 21  # header + 20 fixes
    xrows = np.loadtxt(xlog, delimiter=",")
    assert xrows.shape == (20, 9)


def test_cli_survey(tiny_capture, tmp_path):
    cap, hand = tiny_capture
    out = tmp_path / "survey.json"
    r = _run("survey", str(cap), "--handoff", str(hand), "--blocks", "48",
             "--batch", "8", "--fine-n", "15", "--json", str(out))
    assert r.returncode == 0, r.stderr[-800:]
    assert "sigma ENU+clk" in r.stdout
    payload = json.loads(out.read_text())
    assert len(payload["x_ecef"]) == 8
    assert payload["n_batches"] == 6
    assert all(s > 0 for s in payload["sigma_pos"])


def test_cli_dpe_config_overrides(tiny_capture, tmp_path):
    cap, hand = tiny_capture
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"interp": "linear", "l_power": 2}))
    r = _run("dpe", str(cap), "--handoff", str(hand), "--blocks", "3",
             "--config", str(cfg), "--set", "engine=real",
             "--watchdog", "600")
    assert r.returncode == 0, r.stderr[-800:]


def test_cli_console_dofile(tiny_capture, tmp_path):
    cap, hand = tiny_capture
    script = tmp_path / "s.dofile"
    script.write_text(
        f"newflow f {cap} {hand}\nsetparam f interp linear\n"
        f"startflow f 3\nstatus\nquit\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from navlab_dpe_sdr_tpu.console import Console;"
         f"c = Console(); c.onecmd('dofile {script}')"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-500:]
    assert "final fix" in r.stdout


def _console():
    import io

    from navlab_dpe_sdr_tpu.console import Console
    out = io.StringIO()
    return Console(stdout=out), out


def test_console_prefix_abbrev_alias_history(tiny_capture):
    cap, hand = tiny_capture
    c, out = _console()
    # unique prefixes resolve (reference cmdParser minimal abbreviations)
    c.onecmd(f"newf f1 {cap} {hand}")
    c.onecmd("setp f1 interp linear")
    c.onecmd("addal f1 primary")
    c.onecmd("setp primary l_power 2")       # via alias
    c.onecmd("lsf")
    c.onecmd("s")                            # ambiguous
    c.precmd("lsf")                          # history records via precmd
    c.onecmd("hist")
    text = out.getvalue()
    assert "flow f1 created" in text
    assert "f1.interp = linear" in text
    assert "primary -> f1" in text
    assert "f1.l_power = 2" in text          # alias resolved to f1
    assert "aliases=primary" in text
    assert "ambiguous command 's'" in text
    assert "lsf" in text.splitlines()[-1] or "lsf" in text


def test_console_active_flow_and_delflow(tiny_capture):
    cap, hand = tiny_capture
    c, out = _console()
    c.onecmd(f"newflow a {cap} {hand}")
    c.onecmd(f"newflow b {cap} {hand}")
    c.onecmd("actflow b")
    c.onecmd("setparam interp linear")       # 2-arg form -> active flow
    assert c.flows["b"].overrides["interp"] == "linear"
    assert "interp" not in c.flows["a"].overrides
    c.onecmd("delflow b")
    assert "b" not in c.flows
    assert c.active == "a"


def test_console_stopflow_midrun(tiny_capture):
    """Background startflow + stopflow stops before the block budget
    (reference Flow::Stop join semantics, flow.cu:89-103)."""
    cap, hand = tiny_capture
    c, out = _console()
    c.onecmd(f"newflow f {cap} {hand}")
    c.onecmd("setparam f interp linear")
    c.onecmd("startflow f 55 &")
    assert "flow f started" in out.getvalue()
    fl = c.flows["f"]
    c.onecmd("status f")
    c.onecmd("stopflow f")
    assert not fl.running
    assert fl.runner.stats.n < 55
    assert "stopped after" in out.getvalue()
    # idempotent: stopping again reports not running
    c.onecmd("stopflow f")
    assert "wasn't running" in out.getvalue()
    c.onecmd("quit")


def test_console_startflow_watchdog_default_and_fires(monkeypatch):
    """startflow enforces the reference's 1.5 s per-block watchdog by
    default (README.md:108, sampleblock.cu:432-447) with `setparam
    watchdog` as the escape hatch; the first iteration (jit compile) gets
    grace, a later stall kills the flow."""
    import time

    import navlab_dpe_sdr_tpu.console as console_mod

    class _SlowRx:
        def __init__(self):
            self.n = 0
            self.fixes = []

        def step(self):
            self.n += 1
            if self.n >= 2:
                time.sleep(0.06)

    monkeypatch.setattr(console_mod._Flow, "build",
                        lambda self: _SlowRx())
    c, out = _console()
    c.onecmd("newflow f cap.dat hand.csv")
    c.onecmd("setparam f watchdog 0.02")
    c.onecmd("startflow f 10")
    assert "failed" in out.getvalue() and "watchdog" in out.getvalue()
    # iteration 1 was exempt (compile grace); iteration 2 tripped it
    assert c.flows["f"].runner.stats.n == 2

    # default (no setparam) is the reference's 1.5 s, not disabled
    c.onecmd("newflow g cap.dat hand.csv")
    c.onecmd("startflow g 2")
    assert c.flows["g"].runner.watchdog_s == 1.5

    # watchdog <= 0 disables
    c.onecmd("newflow h cap.dat hand.csv")
    c.onecmd("setparam h watchdog 0")
    c.onecmd("startflow h 2")
    assert c.flows["h"].runner.watchdog_s is None


def test_console_tab_completion():
    """complete_* hooks (the reference scaffolds completion in
    cmdReader.cpp): command names, flow names/aliases, setparam keys."""
    c, _ = _console()
    c.flows = {"alpha": None, "beta": None}
    c.aliases = {"primary": "alpha"}
    assert "startflow " in c.completenames("start")
    assert c.complete_startflow("al", "", 0, 0) == ["alpha "]
    assert set(c.complete_stopflow("", "", 0, 0)) == {
        "alpha ", "beta ", "primary "}
    keys = c.complete_setparam("eng", "", 0, 0)
    assert "engine " in keys
    assert "watchdog " in c.complete_setparam("watch", "", 0, 0)


class _ConfigSpy:
    """Records jax.config updates without repointing the test process."""

    def __init__(self, monkeypatch, platform="gpu"):
        import jax

        self.updates = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: self.updates.__setitem__(k, v))

        class Dev:
            pass

        dev = Dev()
        dev.platform = platform
        monkeypatch.setattr(jax, "devices", lambda *a: [dev])


def test_select_device_gpu_pins_cuda(monkeypatch):
    from navlab_dpe_sdr_tpu.device import select_device
    spy = _ConfigSpy(monkeypatch, platform="gpu")
    select_device("gpu")
    assert spy.updates == {"jax_platforms": "cuda,cpu"}


def test_select_device_gpu_never_falls_back(monkeypatch):
    """A GPU request that comes up on the CPU raises instead of running."""
    from navlab_dpe_sdr_tpu.device import select_device
    _ConfigSpy(monkeypatch, platform="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        select_device("gpu")


def test_select_device_cpu_and_virtual_devices(monkeypatch):
    from navlab_dpe_sdr_tpu.device import select_device
    spy = _ConfigSpy(monkeypatch)
    select_device("cpu", cpu_devices=4)
    assert spy.updates == {"jax_platforms": "cpu",
                           "jax_num_cpu_devices": 4}


def test_select_device_auto_leaves_default(monkeypatch):
    from navlab_dpe_sdr_tpu.device import select_device
    spy = _ConfigSpy(monkeypatch)
    select_device("auto")
    assert spy.updates == {}
    with pytest.raises(ValueError):
        select_device("tpu")


def test_cli_rejects_tpu_device(capsys):
    from navlab_dpe_sdr_tpu import cli
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "tpu", "console"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <repo>/.jax_cache — never a temporary or per-process name."""
    from navlab_dpe_sdr_tpu import device
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(device.REPO / ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert device.compile_cache_dir() == want
    spy = _ConfigSpy(monkeypatch)
    assert device.use_compile_cache() == want
    assert spy.updates == {"jax_compilation_cache_dir": want}


def test_bench_subcommand_runs_in_process(monkeypatch):
    """`cli bench` runs bench.main inside the CLI's own process: a second
    JAX process could not open the card."""
    import runpy
    import subprocess

    from navlab_dpe_sdr_tpu import cli
    calls = []
    monkeypatch.setattr(runpy, "run_path",
                        lambda path: {"main": lambda argv: calls.append(
                            (path, argv))})
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail(
        "bench must not start a child process"))
    monkeypatch.setattr(cli, "select_device", lambda *a, **k: None)
    monkeypatch.setattr(cli, "use_compile_cache", lambda: None)
    cli.main(["bench", "--blocks", "7"])
    assert len(calls) == 1
    assert calls[0][0].endswith("bench.py") and calls[0][1] == ["7"]
