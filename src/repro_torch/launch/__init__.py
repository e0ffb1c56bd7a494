"""Entry points of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; ``mesh`` builds the production
and host meshes over ``init_device_mesh`` and holds the card's
constants."""
