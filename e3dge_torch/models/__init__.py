"""Modules of the PyTorch port, keeping the reference's state_dict names."""
