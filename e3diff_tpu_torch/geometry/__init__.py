"""Backbone reconstruction (NERF) and PDB output."""
