"""The four user examples on the port (PyTorch ports of ``examples/``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.hpc_migration
    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300]

Each runs on ``cuda:0`` and raises without a card, like every entry point
of the port; ``--platform cpu`` runs it on the host CPU. Each keeps the
JAX example's Imagefile verbatim and prints the same lines; ``--root``
names the runtime root (default: a new temporary directory), and each
``main(argv)`` returns what it measured.
"""
