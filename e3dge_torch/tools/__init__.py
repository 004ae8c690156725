"""Offline tools of the port, as CLIs: `python -m e3dge_torch.tools.calc_losses`
(metrics between two image folders) and `python -m
e3dge_torch.tools.gallery_video` (a gallery video from the eval CLI's
trajectories)."""
