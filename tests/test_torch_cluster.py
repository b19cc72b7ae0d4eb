"""The port's cluster front end against the reference's, on the CPU.

``repro_torch.cluster`` copies ``repro.cluster``'s traces, simulator and
routing policies (numpy only) and ports its ``ClusterServer`` onto the
port's ``BatchedServer``.  Here: every ``make_trace`` spec and seed gives
the reference's trace to the last float; ``ClusterSim``'s ``event_log``
and ``ClusterStats.to_json()`` equal the reference's under every policy,
in both cost worlds, on Poisson and bursty traces (and under a property
test over seeds and rates); ``ReplicaSpec.from_config`` and the roofline
phase times equal the reference's when both are given the same peaks,
while the port's defaults are the H100 data sheet's; ``ClusterServer``
over two reduced granite-3-2b replicas (weights converted with
``from_jax_params``) routes and streams as the reference's does; and
``run_trace`` on a fake clock, so nothing depends on the host's speed.
"""
import dataclasses
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.cluster as jcl
import repro_torch.cluster as tcl
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.planner import DCN_LINK as JDCN, ICI_LINK as JICI
from repro.launch import roofline as jroof
from repro.models import init_params as jinit_params
from repro.runtime import BatchedServer as JBatchedServer, ServerConfig as JServerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.core.planner import DCN_LINK, ICI_LINK
from repro_torch.launch import roofline as troof, serve
from repro_torch.models import from_jax_params
from repro_torch.runtime import BatchedServer, ServerConfig

POLICIES = ("round-robin", "jsq", "greedy", "max-flow")
WORLDS = ("electrical", "optical")
TRACE_SPECS = ("poisson:100", "poisson:7.5", "bursty:100", "bursty:100,2", "bursty:30,3")
ARCHS = ("granite-3-2b", "rwkv6-7b", "zamba2-2.7b", "llama4-scout-17b-a16e")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def hetero_specs(cl, ici, dcn, batch=4):
    """tests/test_cluster.py's fast+slow pair: a 4x decode-step gap on
    different links."""
    return [cl.ReplicaSpec.from_times("fast", batch, prefill_token_s=1e-4,
                                      decode_step_s=5e-4, link=ici),
            cl.ReplicaSpec.from_times("slow", batch, prefill_token_s=4e-4,
                                      decode_step_s=2e-3, link=dcn)]


def _both(fn):
    """``fn(cluster module, ICI, DCN)`` for the reference and the port."""
    return fn(jcl, JICI, JDCN), fn(tcl, ICI_LINK, DCN_LINK)


def _rows(trace):
    return [r.to_json() for r in trace]


# --------------------------------------------------------------------------
# traces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 7))
@pytest.mark.parametrize("spec", TRACE_SPECS)
def test_trace_equals_reference(spec, seed):
    kw = dict(n=24, seed=seed, prompt_tokens=(8, 64), new_tokens=(4, 16))
    j, t = jcl.make_trace(spec, **kw), tcl.make_trace(spec, **kw)
    assert _rows(t) == _rows(j)  # arrival floats to the last bit
    assert [r.rid for r in t] == list(range(24))


def test_replay_and_save_round_trip_equal_reference(tmp_path):
    trace = jcl.bursty_trace(12, rate_rps=40.0, burst=3, seed=5)
    jcl.save_trace(trace, tmp_path / "j.json")
    tcl.save_trace(tcl.replay_trace(str(tmp_path / "j.json")), tmp_path / "t.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert tcl.trace_to_json(tcl.make_trace(str(tmp_path / "j.json"), n=0, seed=0)) == \
        jcl.trace_to_json(trace)
    rows = json.loads((tmp_path / "j.json").read_text())["requests"][::-1]
    assert _rows(tcl.replay_trace(rows)) == _rows(jcl.replay_trace(rows))


def test_trace_refusals_equal_reference():
    for call in (lambda cl: cl.poisson_trace(4, rate_rps=0.0, seed=0),
                 lambda cl: cl.bursty_trace(4, rate_rps=1.0, burst=0),
                 lambda cl: cl.poisson_trace(4, rate_rps=1.0, seed=0, prompt_tokens=(9, 8)),
                 lambda cl: cl.make_policy("nope")):
        msgs = []
        for cl in (jcl, tcl):
            with pytest.raises(ValueError) as err:
                call(cl)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------
# the simulator and the policies
# --------------------------------------------------------------------------

def _sim(cl, specs, policy, world, trace):
    sim = cl.ClusterSim(specs, cl.make_policy(policy), world=world)
    stats = sim.run(trace)
    return list(sim.event_log), json.dumps(stats.to_json(), sort_keys=True), stats.summary()


@pytest.mark.parametrize("kind", ("poisson", "bursty"))
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sim_event_log_and_stats_equal_reference(policy, world, kind):
    def run(cl, ici, dcn):
        trace = (cl.poisson_trace(48, rate_rps=200.0, seed=11) if kind == "poisson"
                 else cl.bursty_trace(48, rate_rps=200.0, burst=4, seed=11))
        return _sim(cl, hetero_specs(cl, ici, dcn), policy, world, trace)

    (jlog, jstats, jsum), (tlog, tstats, tsum) = _both(run)
    assert tlog == jlog
    assert tstats == jstats
    assert tsum == jsum
    again = run(tcl, ICI_LINK, DCN_LINK)  # the same seed replays the same log
    assert again[0] == tlog and again[1] == tstats


@settings(max_examples=20, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**20), rate=st.floats(10.0, 500.0),
       policy=st.sampled_from(POLICIES), world=st.sampled_from(WORLDS),
       burst=st.integers(1, 5))
def test_sim_equals_reference_property(seed, rate, policy, world, burst):
    def run(cl, ici, dcn):
        trace = cl.bursty_trace(20, rate_rps=rate, burst=burst, seed=seed)
        return _sim(cl, hetero_specs(cl, ici, dcn, batch=2), policy, world, trace)

    j, t = _both(run)
    assert t[:2] == j[:2]


@pytest.mark.parametrize("arch", ARCHS)
def test_replica_spec_from_config_equals_reference_with_explicit_peaks(arch):
    """Both packages priced on the same peaks (the port's own H100
    figures) give the same spec, phase times and simulation."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    peaks = dict(peak_flops=troof.PEAK_FLOPS, hbm_bw=troof.HBM_BW)
    js = jcl.ReplicaSpec.from_config("r", jcfg, 4, link=JDCN, **peaks)
    ts = tcl.ReplicaSpec.from_config("r", tcfg, 4, link=DCN_LINK, **peaks)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for n in (1, 8, 512):
        assert ts.prefill_time_s(n) == js.prefill_time_s(n) == \
            troof.prefill_time_s(tcfg, n) == jroof.prefill_time_s(jcfg, n, **peaks)
        assert ts.decode_step_time_s(n) == js.decode_step_time_s(n) == \
            troof.decode_step_time_s(tcfg, n) == jroof.decode_step_time_s(jcfg, n, **peaks)
    assert troof._weight_bytes(tcfg) == jroof._weight_bytes(jcfg)

    def run(cl, spec, trace):
        return _sim(cl, [spec, dataclasses.replace(spec, name="r2", chips=2)], "greedy",
                    "electrical", trace)

    assert run(tcl, ts, tcl.poisson_trace(16, rate_rps=50.0, seed=2)) == \
        run(jcl, js, jcl.poisson_trace(16, rate_rps=50.0, seed=2))


def test_port_defaults_are_h100_spec_sheet_figures():
    """The reference's defaults are a TPU v5e's (197 TFLOP/s, 819 GB/s);
    the port's are the H100 SXM data sheet's, those chip_smoke.py bounds
    its kernels with."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW) == (989e12, 3.35e12)
    cfg = get_config("granite-3-2b")
    spec = tcl.ReplicaSpec.from_config("r", cfg, 4)
    assert (spec.peak_flops, spec.hbm_bw) == (989e12, 3.35e12)
    field = {f.name: f.default for f in dataclasses.fields(tcl.ReplicaSpec)}
    assert (field["peak_flops"], field["hbm_bw"]) == (989e12, 3.35e12)
    # granite decode at batch 1 streams 5.07 GB: 1.5 ms at 3.35 TB/s
    assert spec.decode_step_time_s(1) == pytest.approx(troof._weight_bytes(cfg) / 3.35e12)


@pytest.mark.parametrize("policy", POLICIES)
def test_route_batch_on_loaded_views_equals_reference(policy):
    """One routing decision on snapshots with queues, active slots, backlog
    and busy links, for a burst of mixed requests."""
    def route(cl, ici, dcn):
        specs = hetero_specs(cl, ici, dcn, batch=3) + [
            cl.ReplicaSpec.from_times("mid", 2, prefill_token_s=2e-4, decode_step_s=1e-3)]
        sim = cl.ClusterSim(specs, None)
        views = [cl.ReplicaView(index=i, spec=s, queue_len=q, active=a, backlog_s=b,
                                link_free_in_s=lf, tx_time_s=lambda nb, s=s: sim.tx_time_s(s, nb))
                 for i, (s, q, a, b, lf) in enumerate(zip(
                     specs, (0, 3, 1), (3, 1, 0), (4e-3, 1e-2, 2e-3), (0.0, 1e-4, 5e-5)))]
        burst = [cl.Request(rid=i, arrival_s=0.5, prompt_tokens=8 + 9 * i, new_tokens=4 + i)
                 for i in range(6)]
        pol = cl.make_policy(policy)
        return pol.route_batch(burst, views, 0.5), pol.route_batch(burst[:1], views, 0.5)

    j, t = _both(route)
    assert t == j


# --------------------------------------------------------------------------
# the measured front end over the port's BatchedServer
# --------------------------------------------------------------------------

SCFG = dict(batch_size=2, max_seq=32, max_new_tokens=4)


def _replica_cfgs(get, red):
    """Reduced granite-3-2b and a replica twice as deep."""
    cfg = red(get("granite-3-2b"))
    return [cfg, dataclasses.replace(cfg, num_layers=2 * cfg.num_layers)]


@pytest.fixture(scope="module")
def replicas():
    """(reference servers, port servers): replica i's weights drawn by the
    reference's init from key i (x40, see tests/test_torch_model.py) and
    converted to the port."""
    jservers, tservers = [], []
    for i, (jc, tc) in enumerate(zip(_replica_cfgs(jget_config, jreduced),
                                     _replica_cfgs(get_config, reduced))):
        tree = jax.tree_util.tree_map_with_path(
            lambda path, a: np.asarray(a) * (1.0 if path[-1].key == "scale" else 40.0),
            jinit_params(jax.random.key(i), jc))
        jservers.append(JBatchedServer(jc, jax.tree.map(jnp.asarray, tree),
                                       JServerConfig(**SCFG)))
        tservers.append(BatchedServer(tc, from_jax_params(tree, tc, device="cpu"),
                                      ServerConfig(**SCFG), device="cpu"))
    return jservers, tservers


def _prompts(n):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, int(rng.integers(4, 10))) for _ in range(n)]


@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_server_streams_and_routing_equal_reference(replicas, policy):
    """Two bursts, the second while the first is in flight (so the views
    carry queues, active slots and backlog): the same routes, the same
    token streams, the same per-replica counts."""
    out = []
    for cl, servers, ici, dcn in ((jcl, replicas[0], JICI, JDCN),
                                  (tcl, replicas[1], ICI_LINK, DCN_LINK)):
        for srv in servers:
            srv.reset()
        cs = cl.ClusterServer(servers, hetero_specs(cl, ici, dcn, batch=2),
                              cl.make_policy(policy))
        prompts = _prompts(7)
        gids = cs.submit_batch(prompts[:4])
        cs.engine_step()
        gids += cs.submit_batch(prompts[4:])
        res = cs.run_until_drained()
        rep = cs.drain_report()
        out.append((gids, dict(cs._route), res, dict(cs.routed), rep.total_tokens(),
                    [(r.rid, r.replica, r.prompt_tokens, r.new_tokens) for r in rep.records]))
    assert out[1] == out[0]
    gids, _, res, routed, tokens, _ = out[1]
    assert sorted(res) == gids == list(range(7))
    assert sum(routed.values()) == 7 and tokens == 7 * SCFG["max_new_tokens"]


class FakeClock:
    """Advances a fixed step on every call: time counts calls, not host
    speed."""

    def __init__(self, step=1e-3):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def _run_trace_on_fake_clock(tservers, policy):
    clock = FakeClock()
    for srv in tservers:
        srv.reset()
        srv.clock = clock
    specs = hetero_specs(tcl, ICI_LINK, DCN_LINK, batch=2)
    trace = tcl.poisson_trace(10, rate_rps=100.0, seed=4, prompt_tokens=(8, 8),
                              new_tokens=(4, 4))
    cs = tcl.ClusterServer(tservers, specs, tcl.make_policy(policy), clock=clock)
    stats = cs.run_trace(trace, prompts=[p % 256 for p in _prompts(10)])
    return trace, stats


@pytest.mark.parametrize("policy", ("round-robin", "greedy"))
def test_run_trace_on_a_fake_clock(replicas, policy):
    """run_trace paces arrivals on its clock; with a clock that counts
    calls, the same trace replays the same stats to the last float, every
    request finishes with ordered timestamps, and routing accounts for all."""
    tservers = replicas[1]
    try:
        trace, stats = _run_trace_on_fake_clock(tservers, policy)
        _, again = _run_trace_on_fake_clock(tservers, policy)
    finally:
        for srv in tservers:
            srv.clock = time.perf_counter
    assert json.dumps(stats.to_json(), sort_keys=True) == \
        json.dumps(again.to_json(), sort_keys=True)
    assert len(stats.records) == len(trace) and sum(stats.routed.values()) == len(trace)
    for rec, req in zip(stats.records, trace):
        assert rec.new_tokens == SCFG["max_new_tokens"]
        assert req.arrival_s <= rec.arrival_s  # submitted once its arrival elapsed
        assert rec.arrival_s <= rec.enqueue_s <= rec.prefill_start_s \
            <= rec.prefill_done_s <= rec.decode_start_s <= rec.finish_s
    assert stats.makespan_s > 0 and set(stats.busy_s) == {"fast", "slow"}


def test_measure_replica_times_on_a_fake_clock(replicas, monkeypatch):
    """Calibration reads the warm run's timestamps: on a clock that counts
    calls, prefill is (prefill_done - prefill_start) / prompt tokens and a
    decode step the decode span over the decode steps, as in the reference."""
    from repro_torch.cluster import frontend

    tc = _replica_cfgs(get_config, reduced)[0]
    params = replicas[1][0].params
    got = []
    for _ in range(2):
        monkeypatch.setattr(frontend, "BatchedServer",
                            functools.partial(BatchedServer, clock=FakeClock(step=0.5)))
        got.append(tcl.measure_replica_times(tc, params, ServerConfig(**SCFG),
                                             prompt_tokens=8, device="cpu"))
    assert got[0] == got[1]
    prefill_token_s, decode_step_s = got[0]
    assert prefill_token_s == pytest.approx(0.5 / 8)  # two clock calls apart
    assert decode_step_s > 0


def test_launch_serve_cluster_runs_on_cpu(capsys):
    out = serve.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                      "--replicas", "2", "--hetero", "--hetero-factor", "2",
                      "--policy", "greedy", "--requests", "4", "--new-tokens", "4",
                      "--trace", "bursty:50,2"])
    text = capsys.readouterr().out
    for tag in ("[serve/cluster] r0: layers=2", "[serve/cluster] r1-deep: layers=4",
                "[serve/cluster] simulated(greedy)", "[serve/cluster] measured(greedy)",
                "[serve/cluster-json] ", "[serve/kernels] "):
        assert tag in text, tag
    blob = json.loads(text.split("[serve/cluster-json] ", 1)[1].splitlines()[0])
    assert blob["simulated"]["requests"] == blob["measured"]["requests"] == 4
    assert sum(blob["measured"]["routed"].values()) == 4
    assert out["measured"].total_tokens() == 16
    assert all(len(v) == 4 for v in out["results"].values())
    assert out["event_log"] and out["event_log"][0][1] == "route"


def test_launch_serve_cluster_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour; this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--reduced", "--replicas", "2"])
