"""Fault-tolerant training with snapshot-bound checkpoints, on the
PyTorch/CUDA port.

    python3 examples/torch_train_checkpointed.py [--steps 40]                # on the card
    python3 examples/torch_train_checkpointed.py --device cpu                # the plain PyTorch path

``examples/train_checkpointed.py`` on ``repro_torch``: the same model, data
and printout.  Trains a small qwen2.5-family model on the synthetic
pipeline with the full train step (microbatched gradient accumulation,
remat, AdamW), saving async checkpoints through the Iceberg-style catalog;
then simulates a crash and resumes from the latest committed snapshot.
The steps after the committed one run twice, before the crash and after
the resume, and their losses must agree.  ``main`` returns the facts: the
step resumed at, the steps available, and the losses of both runs.
"""

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.iceberg.catalog import RestCatalog  # noqa: E402
from repro_torch.kernels.device_cache import resolve_device  # noqa: E402
from repro_torch.lakehouse.objectstore import ObjectStore  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.optimizer import adamw_init, tree_map  # noqa: E402
from repro_torch.training.train_loop import TrainStepConfig, make_train_step  # noqa: E402


def main(device="cuda", steps: int = 30, layers: int = 4, d_model: int = 256) -> dict:
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        reduced(get_config("qwen2.5-3b")),
        num_layers=layers, d_model=d_model, d_ff=d_model * 4,
        num_heads=8, num_kv_heads=2, head_dim=d_model // 8, vocab_size=2048,
    )
    model = build_model(cfg, device=dev)
    step, _ = make_train_step(model, None, cfg=TrainStepConfig(microbatches=2, lr=1e-3, remat=True),
                              device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    print(f"model: {model.param_count(params)/1e6:.1f}M params "
          f"({cfg.num_layers}L × d{cfg.d_model})")

    facts = {"losses": {}, "resumed_losses": {}}
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(RestCatalog(ObjectStore(root)), async_save=True, keep_last=3)
        data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64, batch_size=8, seed=0)

        crash_at = steps // 2
        t0 = time.time()
        for i in range(crash_at + 3):
            ids, labels = data.batch(i)
            params, opt, m = step(params, opt, ids, labels)
            loss = facts["losses"][i] = float(m["loss"])
            if i % 5 == 0 or i == crash_at:
                mgr.save(i, {"params": params, "opt": opt}, metrics={"loss": m["loss"]})
                print(f"  step {i:3d} loss {loss:.3f} "
                      f"gnorm {float(m['grad_norm']):.2f}  [checkpointed]")
            else:
                print(f"  step {i:3d} loss {loss:.3f}")
        mgr.wait()

        print(f"== simulated crash after step {crash_at + 2}; resuming from catalog ==")
        like = {"params": tree_map(torch.zeros_like, params),
                "opt": tree_map(torch.zeros_like, opt)}
        del params, opt
        restored, at = mgr.restore(like)
        params, opt = restored["params"], restored["opt"]
        facts["resumed_at"], facts["available"] = at, mgr.available_steps()
        print(f"  restored committed step {at} "
              f"(available: {facts['available']})")
        for i in range(at + 1, steps):
            ids, labels = data.batch(i)
            params, opt, m = step(params, opt, ids, labels)
            loss = facts["resumed_losses"][i] = float(m["loss"])
            if i % 5 == 0:
                print(f"  step {i:3d} loss {loss:.3f}")
    facts["final_loss"] = loss
    print(f"done in {time.time()-t0:.0f}s — final loss {loss:.3f}")
    return facts


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.device, args.steps, args.layers, args.d_model)
