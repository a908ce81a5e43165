"""Unsigned 32-bit word helpers and the numpy <-> mesh state carry."""
