"""Launchers of the LM substrate — port of ``repro.launch``: the step
builders, the slot server and the trainer, on one device."""
