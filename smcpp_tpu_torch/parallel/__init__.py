"""Multi-process execution of the port on torch.distributed: one rank, one
device (``distributed``), the segment- and contig-sharded E-step, decode and
Viterbi (``mesh``), and host-local ingestion (``hostlocal``)."""
