"""Cameras, rays and volume integration of the PyTorch port."""
