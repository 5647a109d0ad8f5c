"""Entry points of the port (``python -m repro_torch.launch.train``) and the
device meshes they run on (``mesh``)."""
