"""Volume and image I/O of the port: byte-range loaders, the streaming ZIP
reader, BVP/RAW readers, PNG output, video encoding and the range-request
file server."""

from .image import read_image, to_uint8, write_png  # noqa: F401
from .loaders import (  # noqa: F401
    AbstractLoader, BytesLoader, FileLoader, HTTPLoader, make_loader,
)
from .readers import (  # noqa: F401
    BVPReader, RAWReader, list_modalities, load_volume, write_bvp,
)
from .zip_range import ZipRangeReader  # noqa: F401
