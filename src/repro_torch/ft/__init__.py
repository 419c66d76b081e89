"""Fault tolerance (counterpart of ``repro.ft``): the straggler probe and
the step-time monitor."""
