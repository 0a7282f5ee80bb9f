"""Runnable examples of the port: ``python -m repro_torch.examples.quickstart``
(the paper's §III-C call sequence) and ``python -m
repro_torch.examples.lb_spinodal`` (the Ludwig-style binary-fluid quench).
Both run on the card unless given ``--device cpu``."""
