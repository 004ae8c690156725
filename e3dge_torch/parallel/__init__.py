"""Data parallelism of the port across ranks (counterpart of
`e3dge_tpu/parallel`): the `dp` axis over `torch.distributed` (`mesh`), a
launcher of rank processes with a time limit (`launch`), and the multi-rank
dry run (`dryrun`). Importing it starts no process and joins no group."""
