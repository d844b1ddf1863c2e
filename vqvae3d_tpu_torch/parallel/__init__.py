"""Data-parallel training over ``torch.distributed`` (counterpart of
``vqvae3d_tpu/parallel/``): the process group (``multihost``) and the
collectives of the train path (``mesh``)."""
