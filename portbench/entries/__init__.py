"""Decode entries: how each traffic mix calls the program, and the plain reference that judges it."""
