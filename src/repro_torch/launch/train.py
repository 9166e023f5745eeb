"""Training launcher.

    python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
        --steps 20 --batch 8 --seq 128 [--device cpu]

Port of ``repro/launch/train.py``, with the same flags plus ``--device``
(CUDA by default; raises without a card).  The mesh is the reference's
choice (``mesh.launch_mesh``): ``--reduced`` (the default) trains the
smoke-scale variant on a 1 x 1 debug mesh (a one-rank group this launcher
starts and tears down); ``--full`` trains the published widths on the
production mesh when launched in a group of 256 ranks, and on one card
with no mesh when launched alone, if the training state fits the card
(:func:`check_fits`: f32 masters, gradients and both AdamW moments, 16
bytes a parameter) and refusing otherwise.  Checkpoints are committed
through the catalog every ``--ckpt-every`` steps (each leaf written whole),
and training resumes from the latest committed snapshot under
``--warehouse``.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced as make_reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.iceberg.catalog import RestCatalog
from repro_torch.kernels.device_cache import resolve_device
from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.models.sharding import mesh_shape
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.train_loop import TrainStepConfig, init_train_state, make_train_step

# bytes a parameter the training state holds on the card: f32 masters,
# f32 gradients and the f32 moments m and v
STATE_BYTES_PER_PARAM = 16
# share of the card's memory the training state may take under --full; the
# rest is for the bf16 weight casts, activations and the logits
FULL_STATE_SHARE = 0.85


def check_fits(model, dev: torch.device) -> int:
    """Refuses a model whose training state exceeds the card's share;
    returns the state's bytes."""
    if dev.type != "cuda":
        raise ValueError("--full trains the published widths on the card; pass --device cuda")
    need = model.param_count() * STATE_BYTES_PER_PARAM
    have = torch.cuda.get_device_properties(dev).total_memory
    if need > FULL_STATE_SHARE * have:
        raise ValueError(f"{model.cfg.name}: {need / 1e9:.1f} GB of training state (f32 params, "
                         f"grads, m and v) do not fit {FULL_STATE_SHARE:.0%} of the card's "
                         f"{have / 1e9:.1f} GB")
    return need


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--warehouse", default=None, help="object-store root (default: tmp)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        return _train(args, dev)
    finally:
        if started:
            mesh_lib.destroy()


def _train(args, dev: torch.device) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    mesh = mesh_lib.launch_mesh(args.reduced, dev)
    model = build_model(cfg, tp=mesh_shape(mesh).get("model", 1) if mesh else 1, device=dev)
    if mesh is None:
        check_fits(model, dev)
    step, _ = make_train_step(
        model, mesh, cfg=TrainStepConfig(microbatches=args.microbatches, lr=args.lr, remat=True),
        device=dev)
    params, opt = init_train_state(model, mesh, seed=0)
    print(f"[train] {args.arch} ({'reduced' if args.reduced else 'FULL'}): "
          f"{model.param_count() / 1e6:.1f}M params on {dev}, mesh {mesh_shape(mesh) if mesh else None}")

    store = ObjectStore(args.warehouse or tempfile.mkdtemp())
    mgr = CheckpointManager(RestCatalog(store), async_save=True)
    start = 0
    try:
        restored, start = mgr.restore({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"[train] resumed from committed step {start}")
        start += 1
    except FileNotFoundError:
        pass

    data = SyntheticTokens(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        num_codebooks=cfg.num_codebooks, seed=0,
    )
    t0 = time.time()
    for i in range(start, args.steps):
        ids, labels = data.batch(i)
        params, opt, m = step(params, opt, ids, labels)
        if i % 5 == 0 or i == args.steps - 1:
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            tok_s = args.batch * args.seq * (i - start + 1) / (time.time() - t0)
            print(f"  step {i:4d} loss {loss:.3f} gnorm {gnorm:.2f} ({tok_s:.0f} tok/s)")
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            mgr.save(i, {"params": params, "opt": opt}, metrics={"loss": m["loss"]})
    mgr.wait()
    print("[train] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
