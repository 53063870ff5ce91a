"""The benchmark's own code: finding cells by name, traffic, the closed
loop over the server, trace reading, FLOP and byte counts, peaks and the
comparison that decides ``correct``.  Nothing here is imported from the
program under test except its entry points (``repro_torch.serve``) and
the names of its spans and kernels."""
