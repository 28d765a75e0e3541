"""Shared neural-network layers of the LM stack."""
