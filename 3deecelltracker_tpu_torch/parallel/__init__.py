"""Ensemble tracking on one card (counterpart of
``3deecelltracker_tpu/parallel/``; its sharded builders wait for
``torch.distributed``, ``ROADMAP.md`` A.5)."""
