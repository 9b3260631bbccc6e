"""Model layers of the ShiftAddViT serving path (counterpart of `repro.nn`)."""
