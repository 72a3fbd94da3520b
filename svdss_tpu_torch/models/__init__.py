from .sfs import SFS  # noqa: F401
from .sv import SV  # noqa: F401
from .cluster import Cluster, SubRead  # noqa: F401
from .clip import Clip  # noqa: F401
from .consensus import Consensus  # noqa: F401
