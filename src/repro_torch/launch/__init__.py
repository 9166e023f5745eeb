"""Launchers.  Port of ``repro/launch``: ``serve`` (one card); ``mesh``,
``train``, the dry-runs and the hill-climb wait for ``models/sharding.py``
and ``training/`` (ROADMAP Queue 1, item 5)."""
