"""Tools (``python -m attngan_torch.tools.<name>``): the counterparts of
the repository's tools/ scripts, and measurement scripts for the port's
kernels, run on the GPU."""
