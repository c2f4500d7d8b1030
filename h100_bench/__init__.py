"""The H100 benchmark of ``bibim_tpu_torch``: the interactive viewer loop
(``host.session.Session``) driven over seeded camera paths, held to a
plain PyTorch reference renderer. ``python3 h100_bench/run.py --help``."""
