"""Logical-axis sharding rules for DTensor meshes (the port's copy of the
reference's ``repro/sharding``)."""
