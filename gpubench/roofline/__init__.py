"""Frozen work counts of the fused sweep families, and the peaks of the card."""
