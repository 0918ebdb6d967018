"""Diamond search's two patterns (the JAX package's `LDSP` and `SDSP`,
diamond.py:54-55), in the order that breaks ties: the large diamond of a
round and the small diamond of the final step. Shared by the search, the
replay kernel's wrapper and the replay's bound."""

LDSP = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0),
        (0, 2), (1, -1), (1, 1), (2, 0))
SDSP = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
