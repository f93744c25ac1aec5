"""Training loops of the port (``nic.train``)."""
