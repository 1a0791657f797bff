"""Data parallelism over ``torch.distributed`` (:mod:`.mesh`, :mod:`.train`)."""
