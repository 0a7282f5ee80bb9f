"""Runnable examples of the port: ``quickstart`` (the paper's §III-C call
sequence), ``lb_spinodal`` (the Ludwig-style binary-fluid quench),
``lb_fleet`` (a fleet of quenches behind ``tdp.FleetDriver``),
``train_lm`` (an LM trained on the synthetic bigram stream) and
``serve_lm`` (that checkpoint served, its continuations scored against
the bigram table); each ``python -m repro_torch.examples.<name>``.  All
run on the card unless given ``--device cpu``."""
