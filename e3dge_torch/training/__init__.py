"""Training of the PyTorch port (counterparts of `e3dge_tpu/training`): losses,
perceptual nets, optimizers and the stage-1 step, and the stage-1 trainer
(`python -m e3dge_torch.training.train`)."""
