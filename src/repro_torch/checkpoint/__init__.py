"""Tree checkpoints to ``.npz`` (``repro/checkpoint``)."""
