"""AnotherMe core phases on tensors: encoding, shingling, the SSH join,
multi-level LCS/MSS scoring and communities; the legacy ``run_anotherme``
entry point; and the paper's baselines (centralized all-pairs, MinHash,
BRP, the row-at-a-time UDF)."""
from repro_torch.core.types import (
    PAD_ID, PAD_KEY, PAD_PLACE, CandidatePairs, EncodedBatch, ScoredPairs,
    TrajectoryBatch,
)
from repro_torch.core.encoding import (
    SemanticForest, encode_batch, encode_codes, encode_places, encode_types, forest_tables,
    make_random_forest, type_codes,
)
from repro_torch.core.shingling import (
    expected_collision_rate, num_shingles, shingle_indices, shingles_from_types,
)
from repro_torch.core.similarity import (
    default_betas, lcs_ref, lcs_wavefront, mss_scores, multi_level_lcs,
    score_pairs,
)
from repro_torch.core.ssh import dedup_pairs, exact_pair_count, ssh_candidates
from repro_torch.core.communities import (
    components_as_sets, connected_components, maximal_cliques, pairs_to_set,
    qa1, qa2,
)
from repro_torch.core.pipeline import AnotherMeConfig, AnotherMeResult, run_anotherme
from repro_torch.core.centralized import centralized_similar_pairs
from repro_torch.core.minhash import minhash_candidates, minhash_signatures
from repro_torch.core.brp import brp_candidates
from repro_torch.core.udf import udf_pipeline
