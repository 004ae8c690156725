"""A frozen copy of the port's plain-PyTorch model, render, loss and step
code (`e3dge_torch` as of the benchmark's first version), with the field
kernel replaced by its plain version (`ops/siren_field.py`). Imports are
rewritten to this package; it imports nothing of `e3dge_torch`. The harness
runs it in float32 with TF32 off, on the weights and inputs it hands the port
too. Later changes never edit it: it is the yardstick `correct` is read from.
"""
