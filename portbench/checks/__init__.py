"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference on the same inputs and weights."""
