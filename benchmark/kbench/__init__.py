"""The benchmark harness of kallisto_tpu_torch: traffic, set-up, the
measured window, the trace and the check (see benchmark/README.md)."""
