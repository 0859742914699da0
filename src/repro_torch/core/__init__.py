"""Codes, repair plans and GF(2^8) arithmetic of the port."""
