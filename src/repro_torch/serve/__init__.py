"""Serving on a mesh (counterpart of ``repro.serve``)."""
