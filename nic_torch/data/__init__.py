"""Host-side asset I/O (port of ``nic.data``)."""
