"""Host syncs of one decision, counted by PyTorch's sync debug mode."""


def read(layer):
    return layer.get("host_syncs")
