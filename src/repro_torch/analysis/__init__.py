"""Roofline analysis: traced FLOP and collective counts, H100 roofline.

Port of ``repro/analysis``: ``flops`` (the jaxpr FLOP counter's
counterpart, a dispatch mode), ``hlo`` (the HLO collective parser's
counterpart, counting DTensor's collectives), ``roofline`` (the H100's
constants) and ``report`` (tables from ``results/torch/*.jsonl``).
"""
