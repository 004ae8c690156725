"""Parallelism of the port across ranks (counterpart of `e3dge_tpu/parallel`):
the `dp` (batch) and `sp` (ray) axes of the device mesh over
`torch.distributed` (`mesh`), a launcher of rank processes with a time limit
(`launch`), and the multi-rank dry run on JAX's mesh shapes (`dryrun`).
Importing it starts no process and joins no group."""
