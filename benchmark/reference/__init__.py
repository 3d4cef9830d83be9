"""Plain reference of kallisto 0.51.1's pseudoalignment, fragment-length
estimate, EM and BUS records, in NumPy and plain PyTorch.

It is independent of the program it judges: it imports neither JAX nor
either kallisto package, builds its own k-mer map from the transcript
FASTA, and reads the program's outputs only to compare them.

A read's equivalence class is the intersection of the transcript sets of
every k-mer of the read found in the index (kallisto's `--no-jump`
result; its k-mer skipping is a shortcut to the same intersection).
"""
