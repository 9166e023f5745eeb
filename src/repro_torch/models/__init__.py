"""The LLM substrate's models: the dense decoder family (``layers``,
``model``).  Port of ``repro/models``; the MoE block, ``rwkv6``, ``mamba2``
and ``sharding`` are still to come (ROADMAP Queue 1, item 5)."""
