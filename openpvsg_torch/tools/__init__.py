"""The port's command-line tools, run as ``python -m openpvsg_torch.tools.<name>``:
``make_synthetic_data``, ``pack_train_cache``, ``train`` and ``test``."""
