"""Where the recurrent families' mesh steps move data, against the
reference's program.

- In subprocesses, on a fake group of 256 ranks (the (data=16, model=16)
  mesh) and of 512 (the (pod=2, 16, 16) mesh), rwkv6-3b and zamba2-1.2b
  at their published widths.  ``lower()`` traces rwkv6-3b's cells at 1
  and 2 layers and zamba2-1.2b's decode and prefill at 8 and 14 (a group
  of 6 mamba layers and the shared block apart) and extends them to the
  full depth; zamba2-1.2b's train step is traced at 6 layers (one shared
  block), its bound scaled to 6 of 38 layers.  Each row moves at most 1.5x
  the reference's global collective bytes (its rows on the same meshes,
  committed below: the reference's ``run_cell`` takes no overrides),
  all-reduce is its largest kind, no collective is issued at
  ``select.int``, ``slice.Tensor`` or ``copy_.default`` (the batch-only
  scan's gathers, the cache copy's), and decode is memory-bound and
  prefill compute-bound, as the reference's rows are.
- The dry-run's folds count what the unfolded loops count, op by op:
  the chunked scans (``launch.specs.folded_scans``) on reduced rwkv6 and
  zamba2 forwards and backwards, and the train step's microbatch loop
  (``specs._run_counted``) on rwkv6-3b's train_4k cell at 1 layer and 4
  microbatches, collectives included.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")

# the reference's global collective bytes (``python -m repro.launch.dryrun
# --arch A --shape S --mesh M``, jax 0.9.0 on the CPU, full depth)
REFERENCE = {
    ("rwkv6-3b", "decode_32k", "single"): 4.33e7,
    ("rwkv6-3b", "decode_32k", "multi"): 2.16e7,
    ("rwkv6-3b", "prefill_32k", "single"): 3.543e11,
    ("rwkv6-3b", "train_4k", "single"): 2.857e13,
    ("zamba2-1.2b", "decode_32k", "single"): 5.35e7,
    ("zamba2-1.2b", "prefill_32k", "single"): 4.382e11,
    ("zamba2-1.2b", "train_4k", "single"): 3.714e12,
}
FULL_DEPTH = {"rwkv6-3b": 32, "zamba2-1.2b": 38}
# (arch, shape, mesh, layers: None for the published depth)
CELLS = {
    "rwkv6-3b": [("rwkv6-3b", "decode_32k", "single", None), ("rwkv6-3b", "prefill_32k", "single", None),
                 ("rwkv6-3b", "train_4k", "single", None), ("rwkv6-3b", "decode_32k", "multi", None)],
    "zamba2-1.2b": [("zamba2-1.2b", "decode_32k", "single", None),
                    ("zamba2-1.2b", "prefill_32k", "single", None),
                    ("zamba2-1.2b", "train_4k", "single", 6)],
}

_ROWS_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
rows = []
for arch, shape, mesh, layers in json.loads(sys.argv[1]):
    over = {"num_layers": layers} if layers else None
    rows.append(dryrun.run_cell(arch, shape, mesh, cfg_overrides=over))
print("ROWS " + json.dumps(rows))
"""

_MICRO_SCRIPT = """
import json
from repro_torch.launch import dryrun, specs
cell = specs.build_cell("rwkv6-3b", "train_4k", dryrun.production_mesh("single"), microbatches=4)
fc, cc, _, _ = specs._run_counted(cell, 1)
cell.microbatches = 1  # the loop unfolded: all four microbatches traced
ufc, ucc, _, _ = specs._run_counted(cell, 1)
print("COUNTS " + json.dumps([[fc.dot, fc.other, dict(fc.by_op), cc.global_bytes, cc.by_kind, cc.by_op],
                              [ufc.dot, ufc.other, dict(ufc.by_op), ucc.global_bytes, ucc.by_kind,
                               ucc.by_op]]))
"""


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": SRC})


def _finish(proc, tag):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.split(tag + " ", 1)[1])


@pytest.fixture(scope="module")
def traced():
    """Each arch's rows and the microbatch check, three processes at once."""
    procs = {arch: _start(_ROWS_SCRIPT, json.dumps(cells)) for arch, cells in CELLS.items()}
    procs["micro"] = _start(_MICRO_SCRIPT)
    got = {"micro": _finish(procs.pop("micro"), "COUNTS")}
    for arch, proc in procs.items():
        for cell, row in zip(CELLS[arch], _finish(proc, "ROWS")):
            got[cell] = row
    return got


@pytest.mark.parametrize("cell", [c for cells in CELLS.values() for c in cells],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}" + (f"-{c[3]}layers" if c[3] else ""))
def test_recurrent_rows_move_what_the_reference_moves(traced, cell):
    arch, shape, mesh, layers = cell
    row = traced[cell]
    coll, rf = row["collectives"], row["roofline"]
    assert row["chips"] == (512 if mesh == "multi" else 256)
    bound = 1.5 * REFERENCE[(arch, shape, mesh)] * (layers or FULL_DEPTH[arch]) / FULL_DEPTH[arch]
    assert coll["global_bytes"] <= bound, (coll["global_bytes"], bound, coll["by_kind"])
    by_kind = coll["by_kind"]
    assert max(by_kind, key=by_kind.get) == "all-reduce", by_kind
    for op in ("select.int", "slice.Tensor", "copy_.default"):
        assert op not in coll["by_op"], (op, coll["by_op"])
    if shape == "decode_32k":
        assert rf["bottleneck"] == "memory", rf
    if shape == "prefill_32k":
        assert rf["bottleneck"] == "compute", rf


def test_folded_microbatches_count_the_unfolded_loop(traced):
    folded, unfolded = traced["micro"]
    assert folded[0] > 0 and folded[3] > 0
    assert folded == unfolded


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_folded_scans_count_the_unfolded_chunks(arch, backward):
    """A reduced forward of 2 x 1,024 tokens (rwkv6: 32 chunks of 32 a
    layer; zamba2: 8 of 128), and its backward from every parameter."""
    from repro_torch.analysis.flops import count_flops
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.specs import folded_scans
    from repro_torch.models.model import build_model, param_shapes
    from repro_torch.training.optimizer import tree_map

    meta = torch.device("meta")
    model = build_model(dataclasses.replace(reduced(get_config(arch)), num_layers=2), device=meta)
    ids = torch.zeros((2, 1024), dtype=torch.int64, device=meta)

    def step(params):
        if backward:
            params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits = model.forward(params, ids)[0]
        if backward:
            logits.float().sum().backward()

    plain = count_flops(step, param_shapes(model))
    with folded_scans():
        folded = count_flops(step, param_shapes(model))
    assert plain.dot > 0
    assert (folded.dot, folded.other) == (plain.dot, plain.other)
    assert dict(folded.by_op) == dict(plain.by_op)


def test_entry_points_default_to_the_card():
    """``init_mamba2_state`` takes the card unless the CPU is named;
    ``rope_freqs`` takes its device from the caller."""
    import inspect

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import layers, mamba2

    cfg = reduced(get_config("zamba2-1.2b"))
    conv, ssm = mamba2.init_mamba2_state(cfg, 2, device="cpu")
    assert ssm.device.type == "cpu" and ssm.shape == (2, 4, 16, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mamba2.init_mamba2_state(cfg, 2)
    assert inspect.signature(layers.rope_freqs).parameters["device"].default is inspect.Parameter.empty
