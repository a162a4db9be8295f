"""Partition rules (``specs``) and the activation-constraint context
(``ctx``): the port of ``repro.sharding``, as rules over a mesh record."""
