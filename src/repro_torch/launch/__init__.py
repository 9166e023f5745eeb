"""Launchers.  Port of ``repro/launch``: ``serve`` and ``train`` (one card);
``mesh``, the dry-runs and the hill-climb wait for ``models/sharding.py``
(ROADMAP Queue 1, item 5c)."""
