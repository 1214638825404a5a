"""The drivers of the traffic mixes, found by name (``traffic/*.json``)."""
