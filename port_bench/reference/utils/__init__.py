"""Part of the PyTorch port (see e3dge_torch/__init__.py)."""
