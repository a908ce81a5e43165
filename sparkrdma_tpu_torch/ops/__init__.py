"""Partitioners and the ring all-to-all kernel (see ``ring_exchange``)."""
