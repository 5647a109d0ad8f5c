"""SPL rule modules of the port — importing this package registers every
rule."""
from . import (spl001_views, spl002_f32pin, spl003_locks,  # noqa: F401
               spl004_version, spl005_host_sync)
