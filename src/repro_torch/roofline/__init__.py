"""The roofline of a step (counterpart of ``repro.roofline``): three terms
from the port's own counts, with the H100's constants
(``analyze``), and the analytic bytes a device moves (``model_bytes``)."""
