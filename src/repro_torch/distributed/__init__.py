"""Distribution layer of the port: int8 gradient compression.

Sharding rules and the mesh-axis all-reduce are not ported yet
(``ROADMAP.md`` §1, item 7).
"""
from .compression import compress, decompress, init_error  # noqa: F401
