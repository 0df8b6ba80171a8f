"""Traffic generators. Each reads the parameters of a cell's traffic mix
(``workloads/<cell>.json``) and a seed, and returns arrays; the program
under test receives only those arrays. The same parameters give every
seed the same sizes."""
