"""Batch tensorization on the device and numpy batch iteration."""
