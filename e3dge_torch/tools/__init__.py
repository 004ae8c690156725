"""Offline tools of the port, as CLIs: `python -m e3dge_torch.tools.calc_losses`
(metrics between two image folders), `python -m
e3dge_torch.tools.gallery_video` (a gallery video from the eval CLI's
trajectories) and `python -m e3dge_torch.tools.convergence_probe` (whether
stage-2 training teaches E1 to beat the global baseline)."""
