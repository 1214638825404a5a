"""The fine-patch serving cell's own rate: the serving driver's
``masks_per_s``, kept apart from the production model's so that each has a
bound that fits its spread (the fine-patch cell is device-bound and
repeats far more closely)."""


def read(outcome):
    return outcome.end_to_end.get("masks_per_s")
