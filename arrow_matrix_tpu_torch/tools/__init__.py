"""Probes of the port on the card: the gather roofline
(``granule_gather_probe``, ``gather_probe``), counterparts of the JAX
package's ``tools/pallas_gather_probe.py`` and ``tools/gather_probe.py``."""
