"""Helpers of the port that import no model code."""
