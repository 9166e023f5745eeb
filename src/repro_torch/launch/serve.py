"""Serving launcher: batched prefill+decode, optional retrieval augmentation.

    python -m repro_torch.launch.serve --arch chatglm3-6b --reduced \
        --batch 4 --prompt 32 --gen 32 [--retrieval] [--device cpu]

Port of ``repro/launch/serve.py``, with the same flags plus ``--device``
(CUDA by default; raises without a card).  ``--retrieval`` builds a small
Vamana corpus index on the fly and fuses the kNN-LM probe into every
decode step (the paper's index as a serving feature).  The mesh is the
reference's choice (``mesh.launch_mesh``): the reduced config (the
default) serves on a 1 x 1 debug mesh (a one-rank group this launcher
starts and tears down); ``--full`` serves the published config on the
production mesh when launched in a group of 256 ranks, and on one card
with no mesh when launched alone; each device's share of the bf16
parameters must fit its memory.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced as make_reduced
from repro_torch.core.vamana import VamanaParams, build_vamana
from repro_torch.kernels.device_cache import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model, torch_dtype
from repro_torch.models.sharding import mesh_shape
from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn
from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns

# share of the card's memory the bf16 parameters may take under --full;
# the rest is for the cache, activations and the (B, V) logits
FULL_PARAM_SHARE = 0.85


def _check_fits(model, dev: torch.device, param_dtype: torch.dtype, shards: int = 1) -> None:
    """Refuses a model whose parameters (every tensor of its tree, a MoE's
    experts included), stored in ``param_dtype`` and split ``shards`` ways,
    exceed the card's share."""
    cfg = model.cfg
    if dev.type != "cuda":
        raise ValueError("--full serves the published widths on the card; pass --device cuda")
    need = model.param_count() * torch.empty((), dtype=param_dtype).element_size() / shards
    have = torch.cuda.get_device_properties(dev).total_memory
    if need > FULL_PARAM_SHARE * have:
        raise ValueError(f"{cfg.name}: {need / 1e9:.1f} GB of parameters do not fit "
                         f"{FULL_PARAM_SHARE:.0%} of the card's {have / 1e9:.1f} GB")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--knn-lambda", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    try:
        return _serve(args, dev)
    finally:
        if started:
            mesh_lib.destroy()


def _serve(args, dev: torch.device) -> int:
    serve_cfg = ServeConfig(knn_lambda=args.knn_lambda if args.retrieval else 0.0)
    param_dtype = torch_dtype(serve_cfg.param_dtype)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    mesh = mesh_lib.launch_mesh(args.reduced, dev)
    tp = mesh_shape(mesh).get("model", 1) if mesh else 1
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, tp=tp, device=dev, generator=gen)
    if not args.reduced:
        _check_fits(model, dev, param_dtype, shards=tp)
    params = model.init(dtype=param_dtype)
    max_len = args.prompt + args.gen
    rng = np.random.default_rng(0)

    probe = index = None
    if args.retrieval:
        head = params["lm_head"].float()
        if head.ndim == 3:  # musicgen: use codebook 0's head space
            head = head[0]
        corpus_tokens = rng.integers(0, cfg.vocab_size, size=2000)
        corpus = head[:, torch.from_numpy(corpus_tokens).to(dev)].T.cpu().numpy() + 0.01 * rng.normal(
            size=(2000, cfg.d_model)
        ).astype(np.float32)
        g = build_vamana(corpus.astype(np.float32), VamanaParams(R=8, L=16),
                         passes=1, batch=256, device=dev)
        index = DeviceAnnIndex.from_graphs([g], payloads=[corpus_tokens], device=dev)
        probe = make_probe_fn(mesh, k=8, L=16, device=dev)

    prefill, decode, sample, _ = make_serve_fns(
        model, mesh, cfg=serve_cfg, retrieval=probe, index_template=index,
        batch_hint=args.batch, max_len_hint=max_len, device=dev)
    ids_shape = (args.batch, args.prompt) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=ids_shape)).to(dev)
    cache = model.init_cache(args.batch, max_len)
    print(f"[serve] {args.arch}: batch={args.batch} prompt={args.prompt} "
          f"gen={args.gen} retrieval={'on' if args.retrieval else 'off'}")
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cache)
    tok = sample(logits)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in range(args.prompt, max_len):
        logits, cache = decode(params, tok, cache, t, index)
        tok = sample(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    print(f"  prefill: {t_prefill*1e3:.0f} ms ({args.batch*args.prompt/t_prefill:.0f} tok/s)")
    print(f"  decode:  {t_decode/args.gen*1e3:.1f} ms/step "
          f"({args.batch*args.gen/t_decode:.0f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
