"""The yardstick: frame content, the plain reference, the roofline
arithmetic and the trace's reduction, frozen here so that a change to the
program cannot move them."""
