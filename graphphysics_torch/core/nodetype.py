"""Node taxonomy for mesh-physics graphs (counterpart of
``graphphysics_tpu/core/nodetype.py``): an integer enum with ``SIZE = 9``
one-hot classes; 8 marks the padding nodes of static-size graphs."""

import enum


class NodeType(enum.IntEnum):
    NORMAL = 0
    OBSTACLE = 1
    AIRFOIL = 2
    HANDLE = 3
    INFLOW = 4
    OUTFLOW = 5
    WALL_BOUNDARY = 6
    PADDING = 8
    SIZE = 9
