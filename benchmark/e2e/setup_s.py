"""Set-up: from the start of the process to the first timed call (host
clock): imports, the card's context, the kernels' build where the checkout
has none, the inputs made on the card, the warm-up calls."""


def read(window):
    return window.setup_s
