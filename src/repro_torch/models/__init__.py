"""The model side of the port (counterpart of ``repro.models``): so far the
hybrid family's serving path (``hybrid.HybridLM.prefill`` / ``decode_step``)
and the modules it runs on."""
