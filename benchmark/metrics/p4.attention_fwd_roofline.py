"""``attention_fwd_roofline``, read the same way in the fine-patch serving cell, where it
moves that cell's own rate (``p4.masks_per_s``)."""

from benchmark import harness

read = harness.load_reader("attention_fwd_roofline")
