"""Feature pyramid and the folded decode (port of ``nic.grids``)."""
