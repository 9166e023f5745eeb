"""The port's lifecycle examples held to the reference's.

Each of ``examples/quickstart.py``, ``filtered_search.py`` and
``fault_tolerance_demo.py`` runs as a subprocess beside its port,
``examples/torch_<name>.py --device cpu``.  Both must exit 0 and print the
same lines, with only what a clock or a random id decides masked out (each
mask says why).  Every other fact is compared as printed: counts, files,
S3 bytes, recalls, plan ops and ``est_frac``, plan JSON bytes, replay
identity, inserted / tombstoned / rebuilt, result sets and orphans
reclaimed.  Floats are compared at their printed precision (recall to 3
decimals, ``est_frac`` to 2, S3 MB to 2, Puffin MB to 1): equal to half a
unit of the last printed digit, no looser.  The filtered example's
``fallbacks`` and ``kernel_dispatches`` depend on the built graph (the
port's build is held by recall, not bit equality, as ROADMAP's build-parity
standard says); they are equal today and are held equal.

``examples/torch_serve_retrieval.py`` has no reference run to compare
with: the reference's ``serve_retrieval.py`` stops at a
``ShardingTypeError`` in its jitted decode on this tree.  Its port runs
in-process on the CPU and its facts are asserted directly: the printed
lines, two shards, both throughput lines, retrieval moving the logits, and
every indexed vector's payload its own corpus token.

``examples/torch_train_checkpointed.py`` has none either: the reference's
``train_checkpointed.py`` prints its model line and its first step, then
stops in its second step at the ``ShardingTypeError`` of its
``make_train_step`` (checked here, as ROADMAP Queue 3 records).  The port's example runs in-process on the CPU and is
held to its own facts: the reference's model line, the committed step it
resumes at (15 of 30 steps, saves every 5 and at the crash step), the
steps retained (``keep_last=3``), falling losses, and the two steps run
both before the crash and after the resume giving the same losses.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
MASKED = "<masked>"
# (pattern, why the value is left unasserted); each must match in both runs
MASKS = {
    "quickstart": [
        (r"snapshot \d+", "a snapshot id is drawn at random"),
        (r"snap-\d+-[0-9a-f]+\.puffin", "the Puffin path carries the snapshot id and a uuid"),
        (r"stage0\(sample\+kmeans\)=\S+ stage1\(parallel build\)=\S+ "
         r"stage2\(assemble\+commit\)=\S+", "build stage seconds are the clock's"),
        (r"in [0-9.]+s \(metadata-only commit\)", "the refresh's seconds are the clock's"),
    ],
    "filtered_search": [],
    "fault_tolerance_demo": [
        (r"speculative launches so far: \d+",
         "how many backups launch while the 3 s straggler sleeps depends on timing"),
    ],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """All six subprocesses, started at once; (rc, stdout, stderr) by
    (package, example)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for name in MASKS:
        cwd = str(tmp_path_factory.mktemp(name))
        procs["repro", name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")], env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs["repro_torch", name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), "--device", "cpu"],
            env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        out[key] = (p.returncode, stdout, stderr)
    return out


def _masked_lines(text, masks):
    for pattern, _why in masks:
        text, n = re.subn(pattern, MASKED, text)
        assert n, f"mask {pattern!r} matched nothing"
    return text.splitlines()


@pytest.mark.parametrize("name", sorted(MASKS))
def test_example_prints_the_reference_facts(runs, name):
    rc_ref, out_ref, err_ref = runs["repro", name]
    rc_port, out_port, err_port = runs["repro_torch", name]
    assert rc_ref == 0, err_ref[-2000:]
    assert rc_port == 0, err_port[-2000:]
    assert "terminate called" not in err_port
    want = _masked_lines(out_ref, MASKS[name])
    got = _masked_lines(out_port, MASKS[name])
    assert got == want
    assert got[-1].endswith("done.")


@pytest.mark.parametrize("name", sorted(MASKS) + ["serve_retrieval", "train_checkpointed"])
def test_example_imports_no_jax(name):
    """Importing a port example loads ``repro_torch`` and neither ``jax`` nor
    ``repro``."""
    code = (
        "import runpy, sys\n"
        f"runpy.run_path({str(ROOT / 'examples' / f'torch_{name}.py')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert 'repro_torch' in sys.modules and not bad, bad\n"
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-2000:]


def test_example_main_needs_a_card_by_default():
    """``main()`` runs on the card by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_filtered_search
    finally:
        sys.path.remove(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_filtered_search.main()


@pytest.fixture(scope="module")
def serve_retrieval():
    """``examples/torch_serve_retrieval.py``'s ``main("cpu")``: (printed
    lines, returned facts)."""
    spec = importlib.util.spec_from_file_location(
        "torch_serve_retrieval", ROOT / "examples" / "torch_serve_retrieval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        facts = mod.main("cpu")
    return buf.getvalue().splitlines(), facts


def test_serve_retrieval_prints_the_reference_lines(serve_retrieval):
    """The reference example's lines, in its format (its clock's values
    and the snapshot id free)."""
    lines, _facts = serve_retrieval
    want = [r"== corpus -> lakehouse -> CREATE INDEX ==",
            r"  index built: 2 shards, bound to snapshot \d+",
            r"== batched serving ==",
            r"  decode {16} +\d+\.\d tok/s  \(\d+\.\d ms/step, batch 8\)",
            r"  decode \+ kNN-LM probe +\d+\.\d tok/s  \(\d+\.\d ms/step, batch 8\)",
            r"done\."]
    assert len(lines) == len(want), lines
    for pattern, line in zip(want, lines):
        assert re.fullmatch(pattern, line), (pattern, line)


def test_serve_retrieval_facts(serve_retrieval):
    _lines, facts = serve_retrieval
    assert facts["shards"] == 2
    for label in ("decode", "decode + kNN-LM probe"):
        assert facts[label]["tok_s"] > 0 and facts[label]["ms_step"] > 0
        assert abs(facts[label]["tok_s"] * facts[label]["ms_step"] - 8 * 1e3) < 1e-6 * 8e3
    # lambda 0.3: the retrieved neighbours move the first step's log-probs
    assert facts["knn_shift"] > 1e-4


def test_serve_retrieval_payload_rows():
    """The example finds each indexed vector's corpus row through its
    shard's own file list: on a 4-file table, every decoded vector equals
    the table's row its payload names (the reference's formula, which
    takes the shard-local file number for the table's, names another row
    for the vectors of two of the four files)."""
    import tempfile

    import numpy as np

    from repro_torch.core.blobs import SHARD_BLOB_TYPE, decode_shard_blob
    from repro_torch.iceberg.puffin import PuffinReader
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig

    rng = np.random.default_rng(0)
    X = rng.normal(size=(4000, 16)).astype(np.float32)
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        c = make_local_cluster(root, num_executors=2, device="cpu")
        t = LakehouseTable(c.catalog, "m")
        t.create(dim=16)
        t.append_vectors(X, num_files=4)
        files = [f.path for f in t.current_files()]
        rep = c.coordinator.create_index("m", IndexConfig(
            name="i", R=16, L=32, partitions_per_shard=2, build_passes=1, build_batch=256))
        reader = PuffinReader(c.store.stat(rep.puffin_path).size,
                              c.store.range_reader(rep.puffin_path))
        moved = 0
        for bm in reader.blobs_of_type(SHARD_BLOB_TYPE):
            g, loc = decode_shard_blob(reader.read_blob(bm), device="cpu")
            file_no = np.array([files.index(p) for p in loc.file_paths], np.int64)
            rows = 1000 * file_no[loc.file_idx[: g.n]] + loc.row_offset[: g.n].astype(np.int64)
            np.testing.assert_array_equal(g.vectors[: g.n], X[rows])
            ref_rows = loc.row_offset[: g.n].astype(np.int64) + 1000 * loc.file_idx[: g.n]
            moved += int((ref_rows != rows).sum())
    assert moved > 0  # the partitioner's file order is not the table's here


def test_train_checkpointed_reference_stops_at_its_train_step(tmp_path):
    p = subprocess.run([sys.executable, str(ROOT / "examples" / "train_checkpointed.py")],
                       capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"))
    assert p.returncode != 0
    assert "ShardingTypeError" in p.stderr
    lines = p.stdout.splitlines()
    assert lines[0] == "model: 4.9M params (4L × d256)" and len(lines) == 2, lines
    assert re.fullmatch(r"  step   0 loss \d+\.\d{3} gnorm \d+\.\d\d  \[checkpointed\]", lines[1])


@pytest.fixture(scope="module")
def train_checkpointed():
    spec = importlib.util.spec_from_file_location(
        "torch_train_checkpointed", ROOT / "examples" / "torch_train_checkpointed.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small ops: see test_torch_train_step.py
    try:
        with contextlib.redirect_stdout(buf):
            facts = mod.main("cpu")
    finally:
        torch.set_num_threads(n)
    return buf.getvalue().splitlines(), facts


def test_train_checkpointed_facts(train_checkpointed):
    lines, facts = train_checkpointed
    assert lines[0] == "model: 4.9M params (4L × d256)"
    assert facts["resumed_at"] == 15 and facts["available"] == [5, 10, 15]
    assert sorted(facts["losses"]) == list(range(18))
    assert sorted(facts["resumed_losses"]) == list(range(16, 30))
    losses = facts["losses"]
    assert losses[17] < losses[0] - 2.0, losses
    for i in (16, 17):  # run before the crash and again after the resume
        assert abs(facts["resumed_losses"][i] - losses[i]) < 1e-4, (i, facts)
    want = ([r"model: 4\.9M params \(4L × d256\)"]
            + [rf"  step {i:3d} loss \d+\.\d{{3}}( gnorm \d+\.\d\d  \[checkpointed\])?" for i in range(18)]
            + [r"== simulated crash after step 17; resuming from catalog ==",
               r"  restored committed step 15 \(available: \[5, 10, 15\]\)",
               r"  step  20 loss \d+\.\d{3}", r"  step  25 loss \d+\.\d{3}",
               r"done in \d+s — final loss \d+\.\d{3}"])
    assert len(lines) == len(want), lines
    for pattern, line in zip(want, lines):
        assert re.fullmatch(pattern, line), (pattern, line)
    saved = [i for i, line in enumerate(lines[1:19]) if line.endswith("[checkpointed]")]
    assert saved == [0, 5, 10, 15]
