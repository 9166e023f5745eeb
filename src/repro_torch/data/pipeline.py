"""Token data pipeline.

Two sources behind one iterator protocol:

- :class:`SyntheticTokens` — deterministic Zipf-ish token stream, seeded per
  (host, shard) so multi-host data parallelism reads disjoint streams without
  coordination (each host computes its own slice: the standard stateless
  "index-based" sharding that survives elastic restarts);
- :class:`TokenTableReader` — tokens stored *in the lakehouse*: a vparquet
  ``tokens`` column committed through the same Iceberg catalog as everything
  else, read with row-group granularity.  This is how the end-to-end example
  feeds training from table data, and how embedding extraction writes back.

Batches are (ids, labels) int32 arrays with labels = ids shifted left
(next-token prediction), -100 padding masked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.lakehouse.vparquet import ColumnSpec, VParquetReader, VParquetWriter


@dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    batch_size: int
    num_codebooks: int = 0
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stateless: batch(step) is identical across restarts (elasticity)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.host_id * 7 + self.num_hosts
        )
        shape = (self.batch_size, self.seq_len + 1)
        if self.num_codebooks:
            shape = shape + (self.num_codebooks,)
        # Zipf-ish marginal over the vocab (heavier head, long tail)
        z = rng.zipf(1.3, size=shape)
        ids = np.minimum(z - 1, self.vocab_size - 1).astype(np.int32)
        return ids[:, :-1], ids[:, 1:]


TOKENS_SCHEMA = [ColumnSpec("tokens", "int32", 0)]


def write_token_table(
    store: ObjectStore, key: str, tokens: np.ndarray, rows_per_group: int = 65536
) -> int:
    w = VParquetWriter(TOKENS_SCHEMA)
    tokens = np.ascontiguousarray(tokens.reshape(-1), dtype=np.int32)
    for s in range(0, len(tokens), rows_per_group):
        w.write_row_group({"tokens": tokens[s : s + rows_per_group]})
    data = w.finish()
    store.put(key, data)
    return len(data)


@dataclass
class TokenTableReader:
    store: ObjectStore
    keys: list
    seq_len: int
    batch_size: int
    host_id: int = 0
    num_hosts: int = 1

    def __iter__(self):
        buf = np.empty(0, np.int32)
        need = self.batch_size * (self.seq_len + 1)
        for key in self.keys[self.host_id :: self.num_hosts] or self.keys:
            r = VParquetReader.from_store(self.store, key)
            for rg in range(r.num_row_groups):
                buf = np.concatenate([buf, r.read_column("tokens", [rg])])
                while len(buf) >= need:
                    chunk, buf = buf[:need], buf[need:]
                    ids = chunk.reshape(self.batch_size, self.seq_len + 1)
                    yield ids[:, :-1], ids[:, 1:]
