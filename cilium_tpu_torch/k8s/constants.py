"""Kubernetes integration constants.

Reference: pkg/k8s/apis/cilium.io/const.go and
pkg/k8s/apis/cilium.io/utils/utils.go (label keys used to scope
policies and selectors to namespaces).
"""

# Label every pod-backed endpoint carries: its namespace
# (const.go:43 PodNamespaceLabel).
POD_NAMESPACE_LABEL = "io.kubernetes.pod.namespace"

# Prefix under which the *namespace object's* labels are mirrored onto
# endpoints, so namespaceSelector can match them
# (const.go:40 PodNamespaceMetaLabels).
POD_NAMESPACE_META_LABELS = "io.cilium.k8s.namespace.labels"

# Derived-policy provenance labels (const.go:20,22) — attached to every
# translated rule so rules can be deleted when the k8s object goes away.
POLICY_LABEL_NAME = "io.cilium.k8s.policy.name"
POLICY_LABEL_NAMESPACE = "io.cilium.k8s.policy.namespace"
POLICY_LABEL_SERVICE_ACCOUNT = "io.cilium.k8s.policy.serviceaccount"

# Annotation carrying an override policy name (pkg/annotation Name).
ANNOTATION_NAME = "cilium.io/name"

# Label sources.
SOURCE_K8S = "k8s"
SOURCE_ANY = "any"
SOURCE_RESERVED = "reserved"

# Selector keys (utils.go:33-42).
POD_PREFIX_LBL = f"{SOURCE_K8S}:{POD_NAMESPACE_LABEL}"
POD_ANY_PREFIX_LBL = f"{SOURCE_ANY}:{POD_NAMESPACE_LABEL}"
POD_INIT_LBL = f"{SOURCE_RESERVED}:init"

DEFAULT_NAMESPACE = "default"


def extract_namespace(metadata: dict) -> str:
    """Namespace from an ObjectMeta dict, defaulting like
    pkg/k8s/utils ExtractNamespace."""
    return metadata.get("namespace") or DEFAULT_NAMESPACE


def policy_labels(namespace: str, name: str) -> list:
    """Provenance labels for a translated policy (utils.go GetPolicyLabels)."""
    return [
        f"{SOURCE_K8S}:{POLICY_LABEL_NAME}={name}",
        f"{SOURCE_K8S}:{POLICY_LABEL_NAMESPACE}={namespace}",
    ]
