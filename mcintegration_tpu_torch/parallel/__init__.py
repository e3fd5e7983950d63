from .mesh import (Mesh, default_mesh, gather_rows, init_distributed, make_mesh, mesh_size,
                   ordered_sum)
