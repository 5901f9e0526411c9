"""Command-line entry points: ``train``, ``predict`` and the combined
``grph-torch`` dispatcher (``python -m graphphysics_torch.cli``)."""
