"""The LM stack of the port: configs, parameters, layers, attention, blocks
and the prefill/decode forwards (dense ``attn``/``local`` blocks so far)."""
