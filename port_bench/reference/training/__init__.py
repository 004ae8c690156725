"""Training of the PyTorch port (counterparts of `e3dge_tpu/training`): losses,
perceptual nets, optimizers, the stage-1 step, the stage-2 cycle step and the
discriminator steps, and the trainer (`python -m port_bench.reference.training.train`)."""
