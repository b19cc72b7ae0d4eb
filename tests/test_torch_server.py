"""The port's BatchedServer against the reference's on reduced granite-3-2b.

Both servers get the same weights (the reference's init, random weights
x40, see tests/test_torch_model.py) and the same numpy prompts, and must
emit identical token streams.  Mixed prompt lengths put the slots at
different positions, so the engine step decodes several micro-batches, and
the cross-slot write of the reference's ``engine_step`` (ROADMAP queue C)
shows: a 9-token prompt served beside a 5-token one decodes differently
from the same prompt served alone.  The port mirrors the reference there
too, token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import init_params as jinit_params
from repro.runtime import BatchedServer as JBatchedServer
from repro.runtime import ServerConfig as JServerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import from_jax_params
from repro_torch.runtime import BatchedServer, ServerConfig

SCFG = dict(batch_size=2, max_seq=32, max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def servers():
    """(reference server, port server) over the same weights."""
    jcfg = jreduced(jget_config("granite-3-2b"))
    cfg = reduced(get_config("granite-3-2b"))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (1.0 if path[-1].key == "scale" else 40.0),
        jinit_params(jax.random.key(0), jcfg))
    jsrv = JBatchedServer(jcfg, jax.tree.map(jnp.asarray, tree), JServerConfig(**SCFG))
    srv = BatchedServer(cfg, from_jax_params(tree, cfg, device="cpu"), ServerConfig(**SCFG),
                        device="cpu")
    return jsrv, srv


def _serve(server, prompts):
    server.reset()
    for p in prompts:
        server.submit(p)
    return dict(server.run_until_drained())  # results is cleared by the next reset()


def _prompts():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, 5), rng.integers(0, 256, 9)


def test_token_streams_match_reference_with_cross_slot_defect(servers):
    jsrv, srv = servers
    p5, p9 = _prompts()
    alone_ref, alone = _serve(jsrv, [p9]), _serve(srv, [p9])
    beside_ref, beside = _serve(jsrv, [p5, p9]), _serve(srv, [p5, p9])
    assert alone == alone_ref
    assert beside == beside_ref
    # the reference's defect, mirrored: the slot further along gets the
    # other micro-batch's K/V written into its history
    assert beside[1] != alone[0]
    assert beside[1][:2] == alone[0][:2]


def test_queue_longer_than_slots_matches_reference(servers):
    """More requests than slots: finished slots are refilled from the queue
    between engine steps."""
    jsrv, srv = servers
    p5, p9 = _prompts()
    prompts = [p9, p5, p5[::-1].copy(), p9[::-1].copy()]
    got, want = _serve(srv, prompts), _serve(jsrv, prompts)
    assert got == want
    assert sorted(got) == [0, 1, 2, 3] and all(len(v) == SCFG["max_new_tokens"] for v in got.values())


def test_drain_report_and_reset(servers):
    jsrv, srv = servers
    p5, p9 = _prompts()
    _serve(jsrv, [p5, p9])
    first = _serve(srv, [p5, p9])
    rep, jrep = srv.drain_report(), jsrv.drain_report()
    assert set(rep) == set(jrep)
    assert set(rep["per_request"][0]) == set(jrep["per_request"][0])
    assert rep["requests"] == 2 and rep["tokens"] == 2 * SCFG["max_new_tokens"]
    for r in rep["per_request"]:
        assert (r["enqueue_s"] <= r["prefill_start_s"] <= r["prefill_done_s"]
                <= r["decode_start_s"] <= r["finish_s"])

    srv.submit(p5)  # in flight when reset() is called: drained, then cleared
    srv.reset()
    assert not srv.pending_work() and srv.results == {} and srv.records == {}
    assert srv.drain_report()["requests"] == 0
    assert float(srv.state["k"].abs().sum()) == 0.0
    assert srv.submit(p5) == 0
    srv.reset()
    assert _serve(srv, [p5, p9]) == first


def test_launch_serve_runs_on_cpu(capsys):
    rep = serve.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                      "--requests", "3", "--new-tokens", "4"])
    assert rep["requests"] == 3 and rep["tokens"] == 12
    assert "[serve/kernels]" in capsys.readouterr().out
