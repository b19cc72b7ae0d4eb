"""Run the port's data-parallel training in a world of gloo processes, for
the runs of ``torch_dp_cases``.

    python tests/subproc/torch_dp_world.py --run dense --init INIT.npz --out DIR
    python tests/subproc/torch_dp_world.py --run resume --out DIR

Torch only (no jax).  It spawns ``prod(--mesh)`` ranks through
``repro_torch.launch.world.run_world`` (one CPU thread a rank, a
``FileStore`` in a fresh temporary directory, never a TCP port; a rank that
fails ends the world), and each rank runs ``repro_torch.launch.train.train``
on ``torch_dp_cases.RUNS[NAME]`` with ``--device cpu --ckpt-interval 0``,
starting from the weights in ``--init`` (the reference's ``init_params``
tree, "/"-joined keys, carried across by ``models.from_jax_params``).  Rank
0 prints the launcher's output; each rank r writes ``NAME_rank{r}.npz``:
its final parameters in the reference's layout (layers stacked) and, under
``losses``, the losses it logged.  ``tests/test_torch_dp_train.py`` holds
them to the reference's launcher on 8 fake devices.

``--run resume`` runs ``torch_dp_cases.RESUME`` (2 ranks, the port's own
weights) twice in one world: unbroken into ``OUT/whole``, then, once rank 0
has copied ``OUT/whole`` to ``OUT/cut`` and taken its step-4 checkpoint
away, with ``--resume`` from ``OUT/cut``.  Rank 0 prints both runs' output.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402

import torch_dp_cases as C  # noqa: E402

#: a hung world fails in minutes, not at a test suite's limit
WORLD_TIMEOUT_S = 150


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def reference_layout(params):
    """The port's parameters as numpy leaves keyed as the reference's
    (layers stacked on a leading axis)."""
    from repro_torch.tree import tree_flatten_with_keys, tree_map

    tree = tree_map(lambda a: a.detach().numpy(), params)
    layers = tree.pop("layers")
    tree["layers"] = tree_map(lambda *xs: np.stack(xs), layers[0], *layers[1:])
    return tree_flatten_with_keys(tree)


def _rank(dev, name, init_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import from_jax_params

    def init(cfg, d):
        with np.load(init_path) as f:
            return from_jax_params(_unflatten({k: f[k] for k in f.files}), cfg, device=d)

    args = build_parser().parse_args(C.RUNS[name] + ["--device", "cpu", "--ckpt-interval", "0"])
    trainer = train(dev, args, init=init)
    losses = np.array([m["loss"] for m in trainer.metrics_log])
    np.savez(Path(out_dir) / f"{name}_rank{dist.get_rank()}.npz",
             losses=losses, **reference_layout(trainer.params))


def _resume(dev, out_dir):
    import shutil

    import torch.distributed as dist

    from repro_torch.launch.train import build_parser, train

    whole, cut = Path(out_dir) / "whole", Path(out_dir) / "cut"
    argv = C.RESUME + ["--device", "cpu"]
    train(dev, build_parser().parse_args(argv + ["--ckpt-dir", str(whole)]))
    dist.barrier()  # rank 0's last save has committed
    if dist.get_rank() == 0:
        shutil.copytree(whole, cut)
        shutil.rmtree(cut / "step_00000004")
    dist.barrier()
    train(dev, build_parser().parse_args(argv + ["--ckpt-dir", str(cut), "--resume"]))


def main() -> int:
    from repro_torch.launch.world import run_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=sorted(C.RUNS) + ["resume"], required=True)
    ap.add_argument("--init", help="the initial weights (.npz) of a run of RUNS")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=WORLD_TIMEOUT_S)
    args = ap.parse_args()
    name = f"torch_dp_world --run {args.run}"
    if args.run == "resume":
        run_world(C.world_size(C.RESUME), "cpu", _resume, dict(out_dir=args.out),
                  args.timeout, name)
        return 0
    if args.init is None:
        ap.error(f"--run {args.run} needs --init")
    run_world(C.world_size(C.RUNS[args.run]), "cpu", _rank,
              dict(name=args.run, init_path=args.init, out_dir=args.out), args.timeout, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
