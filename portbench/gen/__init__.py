"""The benchmark's data: contigs drawn from the coalescent HMM of a known
model, from the run's seed."""
