"""Inference step of the RefCOCO evaluation."""
