"""The port's ``launch/perf.py`` sections ``--moe``, ``--faults``,
``--cluster``, ``--reconfig`` and ``--calibrate`` against the reference's,
on the CPU.

A module fixture starts two scripts at once, each in its own subprocess
with a 240 s limit: ``tests/subproc/torch_perf_ref.py`` (the reference's
``faults_bench`` and ``moe_block_bench`` on 8 fake devices) and
``tests/subproc/torch_perf_world.py`` (one world of 8 gloo ranks: the
port's ``moe_block_bench``, ``calibrate_links`` writing a links file,
``collectives_bench`` re-planning with it, and ``calibrate_links`` under
fixed timers; the reference's script runs its ``calibrate_links`` under the
same timers).  The pure-Python sections,
``reconfig_bench`` and the simulated part of ``cluster_bench``, run the
reference's function in this process.  Here:

* the ``--reconfig`` rows and flip, the simulated ``--cluster`` rows and
  policies, and the ``--faults`` prices and re-planned modes equal the
  reference's exactly;
* the ``--moe`` plan sets, issues, modes and cache counters equal the
  reference's and its modeled µs agree within 1e-9 relative, with both
  checks against the all-experts-local block passing;
* the fitted links file loads with ``load_links`` and the collectives
  benchmark runs on it; under fixed timers (a function of the gathered
  payload, the same in both packages) the calibration document equals the
  reference's ``calibrate_links``' exactly, with and without an
  identifiable bandwidth;
* the measured ``--cluster`` part runs on the CPU on a fake clock (so no
  wall-clock ordering is asserted: every request finishes and the rows are
  well formed), and its greedy gate is checked on fixed rows;
* the gates raise the reference's words, ``main`` dispatches each section
  with the reference's defaults, and the device sections raise without a
  card, naming ``device='cpu'``.
"""
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

import repro_torch.cluster as tcl
from repro_torch.core.planner import DCN_LINK, ICI_LINK, load_links
from repro_torch.launch import perf

ROOT = Path(__file__).resolve().parents[1]
SUBPROC = ROOT / "tests" / "subproc"
TIMEOUT_S = 240
POLICIES = "round-robin,jsq,greedy,max-flow"
FAULTS = dict(factors=[2, 4], sizes_kb=[64, 1024], optical_w=8)
MOE_REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(cmd, env):
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(
            f"{' '.join(map(str, cmd))} failed (rc {out.returncode})\n"
            f"--- stdout ---\n{out.stdout[-4000:]}\n--- stderr ---\n{out.stderr[-8000:]}")
    return out.stdout


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    """The two scripts, started when the module's first test runs: the
    in-process tests run while they do."""
    tmp = tmp_path_factory.mktemp("perf")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(tmp))
    env.pop("XLA_FLAGS", None)  # the reference's script sets its own device count
    paths = dict(ref=tmp / "ref.json", port=tmp / "port.json", links=tmp / "links.json")
    with ThreadPoolExecutor(2) as pool:
        futures = dict(
            ref=pool.submit(_run, [sys.executable, str(SUBPROC / "torch_perf_ref.py"),
                                   "--out", str(paths["ref"])], env),
            port=pool.submit(_run, [sys.executable, str(SUBPROC / "torch_perf_world.py"),
                                    "--out", str(paths["port"]),
                                    "--links", str(paths["links"])], env))
        yield futures, paths


@pytest.fixture(scope="module")
def ref_rows(jobs):
    futures, paths = jobs
    futures["ref"].result()
    return json.loads(paths["ref"].read_text())


@pytest.fixture(scope="module")
def port_world(jobs):
    """(rank 0's stdout, its JSON result, the links file) of the world."""
    futures, paths = jobs
    out = futures["port"].result()
    return out, json.loads(paths["port"].read_text()), paths["links"]


@pytest.fixture(scope="module")
def jperf():
    """The reference's ``launch.perf``, imported without letting its
    ``XLA_FLAGS`` default outlive the import."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import perf as mod

    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


# --------------------------------------------------------------------------
# pure-Python sections, against the reference's functions in this process
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n, w", [(16, 2), (8, 2)])
def test_reconfig_rows_and_flip_equal_reference(jperf, n, w):
    got = perf.reconfig_bench(n=n, w=w)
    want = jperf.reconfig_bench(n=n, w=w)
    for key in ("n", "w", "shard_kb", "rows", "flip_at_s"):
        assert got[key] == want[key], key
    assert got["rows"][0]["reconfigurations"] > 0 == got["rows"][-1]["reconfigurations"]


@pytest.mark.parametrize("policies", [POLICIES, "greedy,max-flow"])
def test_cluster_simulated_rows_equal_reference(jperf, policies):
    got = perf.cluster_bench(policies.split(","), measured=False)
    want = jperf.cluster_bench(policies, measured=False)
    for key in ("requests", "seed", "policies", "replicas", "simulated", "measured",
                "ordering_verdicts"):
        assert got[key] == want[key], key
    assert got["policies"][0] == "round-robin"
    assert len(got["simulated"]) == 2 * 2 * len(got["policies"])


def test_cluster_simulated_gate_raises_the_reference_words(jperf, monkeypatch):
    """A greedy policy that routes as round-robin does fails the strict
    p99 gate, in both packages, with the same message."""
    import repro.cluster as jcl

    def rr_for_greedy(make):
        return lambda name: make("round-robin" if name == "greedy" else name)

    monkeypatch.setattr(jcl, "make_policy", rr_for_greedy(jcl.make_policy))
    monkeypatch.setattr(tcl, "make_policy", rr_for_greedy(tcl.make_policy))
    with pytest.raises(SystemExit) as want:
        jperf.cluster_bench("greedy", measured=False)
    with pytest.raises(SystemExit) as got:
        perf.cluster_bench(["greedy"], measured=False)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("--cluster: greedy p99 ")


def test_calibrate_refuses_one_size():
    with pytest.raises(SystemExit, match=r"^--calibrate needs >= 2 sizes in --sizes-kb "
                                         r"to fit alpha and bandwidth$"):
        perf.main(["--collectives", "2,4", "--calibrate", "--sizes-kb", "64",
                   "--device", "cpu"])


def test_moe_refuses_an_axis_that_does_not_divide_the_experts():
    with pytest.raises(SystemExit, match=r"^--moe: llama4-scout-17b-a16e reduced "
                                         r"num_experts=4 not divisible by expert axis "
                                         r"'s0' size 3$"):
        perf.main(["--moe", "3", "--device", "cpu"])


# --------------------------------------------------------------------------
# the measured cluster, on a fake clock
# --------------------------------------------------------------------------

class FakeClock:
    """Advances a fixed step on every call: time counts calls, not host
    speed."""

    def __init__(self, step=1e-3):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_cluster_measured_part_on_a_fake_clock():
    requests = 4
    rows = perf.cluster_measured(["round-robin", "greedy"], requests=requests,
                                 device="cpu", clock=FakeClock())
    assert [r["policy"] for r in rows] == ["round-robin", "greedy"]
    for r in rows:
        assert set(r) == {"policy", "sim_p99_ms", "measured_p99_ms", "sim_p50_ms",
                          "measured_p50_ms", "sim_routed", "measured_routed"}
        for key in ("sim_p99_ms", "measured_p99_ms", "sim_p50_ms", "measured_p50_ms"):
            assert math.isfinite(r[key]) and r[key] > 0, (key, r)
        assert r["measured_p50_ms"] <= r["measured_p99_ms"]
        # run_trace returns only once every request finished
        assert sum(r["measured_routed"].values()) == requests
        assert sum(r["sim_routed"].values()) == requests
        assert set(r["measured_routed"]) == {"fast", "slow"}


def _measured_row(policy, sim_p99, measured_p99):
    return dict(policy=policy, sim_p99_ms=sim_p99, measured_p99_ms=measured_p99)


@pytest.mark.parametrize("sim, meas, ok", [(1.0, 1.0, True), (3.0, 1.0, False),
                                           (1.0, 3.0, False), (2.0, 2.0, False)])
def test_cluster_measured_gate(sim, meas, ok):
    rows = [_measured_row("round-robin", 2.0, 2.0), _measured_row("greedy", sim, meas),
            _measured_row("jsq", 5.0, 5.0)]
    policies = ["round-robin", "greedy", "jsq"]
    if ok:
        verdicts = perf.cluster_verdicts(policies, rows)
        assert verdicts == {"greedy": dict(sim_better=True, measured_better=True),
                            "jsq": dict(sim_better=False, measured_better=False)}
        return
    with pytest.raises(SystemExit) as err:
        perf.cluster_verdicts(policies, rows)
    assert str(err.value) == (
        f"--cluster: greedy-vs-round-robin ordering mismatch "
        f"(sim_better={sim < 2.0} measured_better={meas < 2.0}) — the simulator's "
        f"prediction no longer matches the measured cluster")


# --------------------------------------------------------------------------
# main: dispatch and defaults, and the card by default
# --------------------------------------------------------------------------

def test_main_dispatches_world_sections_with_reference_defaults(monkeypatch):
    calls = []
    monkeypatch.setattr(perf, "run_world", lambda *a: calls.append(a))
    perf.main(["--moe", "2,4", "--device", "cpu"])
    perf.main(["--collectives", "2,4", "--calibrate", "--links", "fit.json",
               "--device", "cpu"])
    (world, dev, target, kwargs, _, _), (world2, _, target2, kwargs2, _, _) = calls
    assert (world, dev, target.__name__) == (8, "cpu", "moe_block_bench")
    assert kwargs == dict(factors=[2, 4], reps=10, links_path=None,
                          archs=["llama4-scout-17b-a16e", "arctic-480b"])
    assert (world2, target2.__name__) == (8, "calibrate_links")
    assert kwargs2 == dict(factors=[2, 4], sizes_kb=[64, 1024], reps=10,
                           links_path="fit.json")


def test_main_dispatches_modeled_sections_with_reference_defaults(monkeypatch):
    calls = {}
    for name in ("reconfig_bench", "cluster_bench", "faults_bench"):
        monkeypatch.setattr(perf, name,
                            lambda *a, name=name, **k: calls.setdefault(name, (a, k)))
    perf.main(["--reconfig"])
    perf.main(["--cluster", "--sim-only"])
    perf.main(["--faults", "2,4"])
    assert calls["reconfig_bench"] == ((), dict(n=16, w=2, bench_json=None))
    assert calls["cluster_bench"] == ((POLICIES.split(","),), dict(
        requests=16, seed=0, bench_json=None, measured=False, device="cuda"))
    assert calls["faults_bench"] == (([2, 4], [64, 1024]), dict(optical_w=None))
    with pytest.raises(SystemExit):
        perf.main(["--reconfig", "--cluster"])  # one section at a time
    with pytest.raises(SystemExit):
        perf.main(["--tp-block", "2,4", "--calibrate"])


@pytest.mark.parametrize("argv", [["--moe", "2,4"],
                                  ["--collectives", "2,4", "--calibrate"],
                                  ["--cluster"]],
                         ids=["moe", "calibrate", "cluster"])
def test_device_sections_need_a_card_unless_cpu_is_asked_for(argv):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perf.main(argv)


# --------------------------------------------------------------------------
# the mesh sections, against the reference on 8 fake devices
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_faults():
    return perf.faults_bench(FAULTS["factors"], FAULTS["sizes_kb"],
                             optical_w=FAULTS["optical_w"])


@pytest.mark.parametrize("i", range(8))
def test_faults_row_equals_reference(port_faults, ref_rows, i):
    got, want = port_faults[i], ref_rows["faults"][i]
    assert got == want
    assert got["elec_degraded_us"] >= got["elec_healthy_us"]
    assert got["opt_degraded_us"] >= got["opt_healthy_us"]


def test_faults_covers_every_collective_and_size(port_faults):
    assert [(r["collective"], r["kb"]) for r in port_faults] == [
        (c, kb) for kb in FAULTS["sizes_kb"] for c in ("ag", "rs", "ar", "a2a")]


@pytest.mark.parametrize("arch", perf.MOE_ARCHS)
def test_moe_plans_and_modeled_times_equal_reference(port_world, ref_rows, arch):
    (got,) = [r for r in port_world[1]["moe"] if r["arch"] == arch]
    (want,) = [r for r in ref_rows["moe"] if r["arch"] == arch]
    for key in ("plans", "a2a_plans", "issued", "modes", "cache"):
        assert got[key] == want[key], key
    for key in ("modeled_elec_us", "modeled_opt_us"):
        assert got[key] == pytest.approx(want[key], rel=MOE_REL, abs=0), key
    assert got["allclose"] is want["allclose"] is True
    assert got["a2a_plans"] >= 1
    assert got["measured_ep_us"] > 0 and got["measured_gspmd_us"] > 0
    assert set(got) == set(want)


def test_calibrated_links_load_and_replan_the_collectives(port_world):
    out, result, links = port_world
    doc = result["calibrate"]
    names = ["s0", "s1"]
    fitted = doc["fitted_links"]
    assert doc["mesh"] == [2, 4] and sorted(fitted) == names
    for name, hard in zip(names, (DCN_LINK, ICI_LINK)):
        entry = fitted[name]
        assert entry["name"] == name and entry["alpha_s"] >= 0
        assert entry["hardcoded"] == {"bandwidth_bytes": hard.bandwidth_bytes,
                                      "alpha_s": hard.alpha_s}
        assert (entry["bandwidth_bytes"] is None) == ("note" in entry)
    assert json.loads(links.read_text()) == doc
    specs = load_links(links, expect_axes=names)
    assert sorted(specs) == names and all(s.bandwidth_bytes > 0 for s in specs.values())
    lines = out.splitlines()
    assert any(ln.startswith("[perf/collectives] using fitted links from ") for ln in lines)
    rows = [ln for ln in lines if ln.startswith("[perf/collectives] ") and "KB mesh=" in ln]
    assert len(rows) == 3 and all(ln.endswith("bit-identical") for ln in rows)
    assert any(ln.startswith("[perf/kernels] ") for ln in lines)


@pytest.mark.parametrize("timing", ["sloped", "steep", "flat", "falling"])
def test_calibrate_document_equals_reference(port_world, ref_rows, timing):
    """Both packages' ``calibrate_links`` on the mesh [2, 4], their timers
    replaced by the same fixed function of the gathered payload: the
    documents (fit, ``hardcoded``, ``note``, ``mesh``) are equal.  A rising
    time identifies a bandwidth; a flat or falling one reports none."""
    got = port_world[1]["calibrate_fixed"][timing]
    want = ref_rows["calibrate_fixed"][timing]
    assert got == want
    assert sorted(got["fitted_links"]) == ["s0", "s1"]
    for entry in got["fitted_links"].values():
        identified = timing in ("sloped", "steep")
        assert (entry["bandwidth_bytes"] is not None) == identified
        assert ("note" in entry) == (not identified)
        assert entry["alpha_s"] > 0
