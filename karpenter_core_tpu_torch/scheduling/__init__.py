from .requirement import Requirement, INFINITE
from .requirements import Requirements, pod_requirements, strict_pod_requirements, label_requirements
from .taints import Taints, tolerates
from . import resources
from .hostports import HostPortUsage, get_host_ports, HostPort
from .volumes import VolumeUsage, Volumes
