"""One module an entry kind, found by the name a workload file gives.

A driver has ``make_pool(config, traffic, seed, device)``, the input
sets of a run; ``stitch(item, cfg, device)``, the timed call of the
port's entry on one of them; ``panoramas(item)``, what that call
completes; and ``reference(item, cfg)``, the same stitch by
``portbench.reference``."""
