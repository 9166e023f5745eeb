#!/usr/bin/env python3
"""Time builds of ``masked_topk.cu`` against each other on one CUDA card.

    python3 tools/masked_ab.py DIR [DIR ...]

Each DIR holds a ``masked_topk.cu`` (a checkout's
``src/repro_torch/kernels/csrc``, or a copy with one constant or loop
changed).  Each source is built with the package's nvcc flags and
``-Xptxas -v`` (registers and spills printed), then the masked calls that
decide the int8 and ADC tiles' design are timed through the package's
wrappers, each build in turn (DIR order, then reversed): device time by
CUDA-graph replay (``chip_smoke.device_ms``, the mean of the two turns) and
the pass-1 / pass-2 split by ``torch.profiler``.  No output is checked, so
a diagnostic variant (a phase of the tile left out) times as well; bits
are held by ``chip_smoke.py --parent``.  Calls: Q = 100, m = 32, K = 256,
k = 160; int8 and ADC on one 250k-row shard under a 50 % mask, one row in
64, none, and (ADC, unified) the plane of ten price masks; phase 6's ADC
masks and phase 7's int8 band on one 4,096-row shard.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import masked_topk as km

    dirs = sys.argv[1:]
    if not dirs or not torch.cuda.is_available():
        print(__doc__.strip().splitlines()[0] + ": needs DIR arguments and a CUDA card")
        return 1
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(out_dir / f"lib{i}.so"), str(Path(d) / "masked_topk.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i, d in enumerate(dirs)]
    libs = []
    for i, p in enumerate(procs):
        log, _ = p.communicate()
        if p.returncode:
            print(log)
            return 1
        for line in log.splitlines():
            if "spill" in line or "registers" in line:
                print(dirs[i], line.strip())
        lib = ctypes.CDLL(str(out_dir / f"lib{i}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    print(cs.phase_environment(torch))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    Q, D, M, KC, k = 100, 128, 32, 256, 160
    calls = {}
    for n in (250_000, cs.SMALL_SHARD):
        q, x, luts, codes, _ = cs._masked_case(torch, dev, rng, Q, n, D, 0.0, m=M, kc=KC)
        price = torch.as_tensor(rng.integers(0, cs.PRICE_MAX, size=n)).to(dev)
        stored, x_scale = ref.quantize_points(x, "int8")
        qs, q_scale = ref.quantize_points(q, "int8")
        sc = (q_scale, x_scale)
        if n != cs.SMALL_SHARD:
            wide = price < 5000
            for label, m in {"50%": wide, **cs._sweep_masks(wide)}.items():
                mu = m.to(torch.uint8).reshape(1, -1).contiguous()
                calls[f"ADC {label} N={n}"] = (lambda m=m, lt=luts, c=codes: ops.masked_pq_topk(lt, c, m, k))
                calls[f"int8 {label} N={n}"] = (lambda mu=mu, qs=qs, st=stored, sc=sc:
                                               km.masked_exact_topk(qs, st, mu, None, k, scales=sc))
            uniq = torch.stack([price < t for t in (2, 3, 4, 5, 6, 100, 325, 550, 775, 1000)])
            idx = torch.as_tensor(np.arange(Q) % uniq.shape[0]).to(dev)
            flavor = torch.arange(Q, device=dev) % 2 == 1
            calls[f"ADC plane N={n}"] = (lambda lt=luts, c=codes, u=uniq, i=idx:
                                         ops.masked_pq_topk_dedup(lt, c, u, i, k))
            calls[f"unified plane N={n}"] = cs._unified_launch(torch, q, x, luts, codes, uniq, idx, flavor, k)
        else:
            for name, (u, i, f) in cs.phase6_masks(torch, price, Q).items():
                calls[f"{name} phase 6"] = (
                    (lambda u=u, i=i, lt=luts, c=codes: ops.masked_pq_topk_dedup(lt, c, u, i, k)) if f is None
                    else cs._unified_launch(torch, q, x, luts, codes, u, i, f, k))
            band = (price < cs.PROD_BF16_BAND).to(torch.uint8).reshape(1, -1).contiguous()
            calls["int8 phase 7"] = (lambda qs=qs, st=stored, b=band, sc=sc:
                                     km.masked_exact_topk(qs, st, b, None, k, scales=sc))
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    print(f"builds {dirs}: device ms by graph replay, mean of two turns (pass 1 + pass 2)")
    for label, fn in calls.items():
        times = {i: [] for i in range(len(libs))}
        split = {}
        for i in order:
            cs._launching("masked_topk", libs[i])
            times[i].append(cs.device_ms(torch, fn, inner=5, reps=10))
            if i not in split:
                split[i] = cs.pass_split_ms(torch, fn)
        print(f"{label}: " + ", ".join(f"{dirs[i]} {np.mean(times[i]):.4f} ({cs._split_text(split[i])})"
                                      for i in range(len(libs))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
