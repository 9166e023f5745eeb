"""Data pipeline: deterministic synthetic + lakehouse-backed token streams."""

from repro_torch.data.pipeline import SyntheticTokens, TokenTableReader, write_token_table  # noqa: F401
