"""Run the port's spec-path training (``--zero1 spec``) in ONE world of 8
gloo processes, for the runs and the resume of ``torch_spec_cases``.

    python tests/subproc/torch_spec_world.py --inits DIR --out DIR

Torch only (no jax).  It spawns 8 ranks through
``repro_torch.launch.world.run_world`` (one CPU thread a rank, a
``FileStore`` in a fresh temporary directory, never a TCP port; a rank that
fails ends the world), and each rank runs ``repro_torch.launch.train.train``
on every run of ``torch_spec_cases.RUNS`` in turn with ``--device cpu
--ckpt-interval 0``, starting from ``init_ARCH.npz`` in ``--inits`` (the
reference's weights, "/"-joined keys, carried across by
``models.from_jax_params``), which it waits for.  Rank 0 prints the
launcher's output.  Per run, rank 0 writes ``NAME_final.npz``: the final
parameters gathered whole (``full_tensor``) in the reference's layout
(layers stacked) and, under ``losses``, the losses it logged; for the runs
of ``SHARDED`` each rank r writes ``NAME_rank{r}.npz``: its local shard of
every parameter (``params/KEY``, the layers' shards stacked) and first
moment (``m/KEY``), and its losses.

Then the resume: ``RESUME`` for ``RESUME_STEPS[0]`` steps with a checkpoint
after each into a fresh directory, and, once rank 0 has committed them,
``--resume`` to ``RESUME_STEPS[1]`` steps; rank 0 writes
``resume_final.npz`` with both parts' losses.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

import torch_spec_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
WORLD_TIMEOUT_S = 200


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _load_init(inits: Path, arch: str, deadline: float):
    path = inits / f"init_{arch}.npz"
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)
    with np.load(path) as f:
        return _unflatten({k: f[k] for k in f.files})


def _flat(tree, prefix, fn):
    """``{prefix + "/"-joined key: fn(leaf)}``; a ``layers`` list's leaves
    are stacked as the reference stacks them."""
    from repro_torch.tree import tree_flatten_with_keys

    rest = {k: v for k, v in tree.items() if k != "layers"}
    out = {prefix + k: fn(v) for k, v in tree_flatten_with_keys(rest).items()}
    layers = tree["layers"]
    if isinstance(layers, list):
        per = [tree_flatten_with_keys(layer) for layer in layers]
        out.update({f"{prefix}layers/{k}": np.stack([fn(p[k]) for p in per]) for k in per[0]})
    else:
        out.update({f"{prefix}layers/{k}": fn(v)
                    for k, v in tree_flatten_with_keys(layers).items()})
    return out


def _train(dev, argv, inits, deadline):
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import from_jax_params

    def init(cfg, d):
        return from_jax_params(_load_init(inits, cfg.name, deadline), cfg, device=d)

    return train(dev, build_parser().parse_args(argv + ["--device", "cpu"]), init=init)


def _rank(dev, inits, out_dir, timeout):
    import torch.distributed as dist

    rank = dist.get_rank()
    out, inits = Path(out_dir), Path(inits)
    deadline = time.monotonic() + timeout

    def full(t):
        return t.full_tensor().detach().numpy()

    for name, argv in C.RUNS.items():
        trainer = _train(dev, argv + ["--ckpt-interval", "0"], inits, deadline)
        losses = np.array([m["loss"] for m in trainer.metrics_log])
        final = _flat(trainer.params, "", full)
        if rank == 0:
            np.savez(out / f"{name}_final.npz", losses=losses, **final)
        if name in C.SHARDED:
            local = lambda t: t.to_local().detach().numpy()  # noqa: E731
            np.savez(out / f"{name}_rank{rank}.npz", losses=losses,
                     **_flat(trainer.params, "params/", local),
                     **_flat(trainer.opt_state["m"], "m/", local))

    ckpt = out / "resume_ckpt"
    first, total = C.RESUME_STEPS
    losses = []
    for steps, extra in ((first, []), (total, ["--resume"])):
        trainer = _train(dev, C.RESUME + ["--steps", str(steps), "--ckpt-interval", "1",
                                          "--ckpt-dir", str(ckpt)] + extra, inits, deadline)
        losses += [m["loss"] for m in trainer.metrics_log]
        dist.barrier()  # rank 0's last save has committed
    final = _flat(trainer.params, "", full)
    if rank == 0:
        np.savez(out / "resume_final.npz", losses=np.array(losses), **final)


def main() -> int:
    from repro_torch.launch.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inits", required=True, help="where init_ARCH.npz appear")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=WORLD_TIMEOUT_S)
    args = ap.parse_args()
    run_world(8, "cpu", _rank, dict(inits=args.inits, out_dir=args.out, timeout=args.timeout),
              args.timeout, "torch_spec_world")
    return 0


if __name__ == "__main__":
    sys.exit(main())
