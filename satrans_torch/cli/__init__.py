"""The experiment entry point (twin of ``satrans_tpu/cli``)."""
