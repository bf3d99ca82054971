"""The architecture zoo's LM stack: configs, layers, attention, MoE, blocks,
the decoder-only LM and the model API (prefill and decode steps)."""
