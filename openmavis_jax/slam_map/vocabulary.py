"""Binary visual vocabulary: hierarchical k-medians over ORB descriptors.

JAX replacement for DBoW2's TemplatedVocabulary (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h — hierarchical k-means tree,
k=10, L=6 for the ORB vocabulary; tf-idf BowVector; L1 scoring). Idiom
shifts (SURVEY.md §2.2):

* the tree is dense arrays (per-level center tables), not node objects;
* training clusters EVERY node of a level simultaneously — one batched
  k-medians (majority-bit centroids, Hamming assignment via the
  Hamming matmul) per level;
* transform (descriptor -> word) is a level-wise batched argmin descent;
* BoW vectors are dense [n_words] tf-idf arrays, so database scoring is a
  matmul (see keyframe_db.py).

The reference repo ships no vocabulary at all (SURVEY.md §6: Vocabulary/ is
absent; build.sh expects a separately downloaded ORBvoc); training our own
is the supported path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import matcher


class Vocabulary(NamedTuple):
    """Dense vocabulary tree: level l has k^(l+1) nodes."""
    centers: tuple          # per level: [k^(l+1), 256] int8 centers
    idf: jnp.ndarray        # [n_words] inverse document frequency
    k: int                  # branching factor

    @property
    def n_words(self):
        return self.centers[-1].shape[0]


def _assign(desc, centers_per_node, node_of_desc):
    """desc [N,256]; centers_per_node [n_nodes, k, 256]; node_of_desc [N].
    Returns child index [N] in 0..k-1 by Hamming argmin."""
    cen = centers_per_node[node_of_desc]          # [N, k, 256]
    d = jnp.sum(jnp.abs(cen.astype(jnp.int32)
                        - desc[:, None, :].astype(jnp.int32)), axis=-1)
    return jnp.argmin(d, axis=-1)


def train(desc: np.ndarray, k: int = 10, levels: int = 3,
          iters: int = 6, seed: int = 0) -> Vocabulary:
    """Train a k^levels-word vocabulary from [N, 256] {0,1} descriptors.

    All nodes of a level are clustered in one batched loop: descriptors
    carry their parent-node id; centroids are per-(node, child) majority
    bits; assignment is Hamming argmin among the k sibling centers.
    """
    desc = np.asarray(desc, np.int8)
    n = len(desc)
    rng = np.random.default_rng(seed)
    desc_j = jnp.asarray(desc)

    node = jnp.zeros((n,), jnp.int32)     # parent node id at current level
    centers_list = []
    n_nodes = 1
    for lv in range(levels):
        # init: random member of each node for each child slot
        perm = rng.permutation(n)
        init = np.zeros((n_nodes, k, 256), np.int8)
        node_np = np.asarray(node)
        for c in range(n_nodes):
            members = perm[node_np[perm] == c]
            if len(members) == 0:
                members = perm[:k]
            sel = members[(np.arange(k) * 2654435761) % len(members)]
            init[c] = desc[sel]
        centers = jnp.asarray(init)

        @jax.jit
        def em(centers, node):
            def step(centers, _):
                child = _assign(desc_j, centers, node)
                slot = node * k + child
                ones = jnp.ones((n,), jnp.float32)
                cnt = jnp.zeros((n_nodes * k,), jnp.float32).at[slot].add(
                    ones)
                bit_sum = jnp.zeros((n_nodes * k, 256),
                                    jnp.float32).at[slot].add(
                    desc_j.astype(jnp.float32))
                new = (bit_sum > 0.5 * cnt[:, None]).astype(jnp.int8)
                keep = (cnt > 0)[:, None]
                flat = jnp.where(keep, new, centers.reshape(-1, 256))
                return flat.reshape(n_nodes, k, 256), None
            centers, _ = jax.lax.scan(step, centers, None, length=iters)
            child = _assign(desc_j, centers, node)
            return centers, node * k + child

        centers, node = em(centers, node)
        centers_list.append(centers.reshape(n_nodes * k, 256))
        n_nodes *= k

    # idf from training counts
    word = np.asarray(node)
    counts = np.bincount(word, minlength=n_nodes).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    return Vocabulary(centers=tuple(centers_list), idf=jnp.asarray(idf),
                      k=k)


def transform(vocab: Vocabulary, desc: jnp.ndarray,
              valid: jnp.ndarray) -> jnp.ndarray:
    """[F, 256] descriptors -> [n_words] L1-normalized tf-idf BoW vector."""
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    k = vocab.k
    for centers in vocab.centers:
        cen = centers.reshape(-1, k, 256)
        child = _assign(desc, cen, node)
        node = node * k + child
    w = vocab.n_words
    tf = jnp.zeros((w,), jnp.float32).at[node].add(
        valid.astype(jnp.float32))
    v = tf * vocab.idf
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-9)


def word_ids(vocab: Vocabulary, desc: jnp.ndarray) -> jnp.ndarray:
    """[F, 256] -> [F] leaf word id (for BoW-gated feature matching)."""
    n = desc.shape[0]
    node = jnp.zeros((n,), jnp.int32)
    k = vocab.k
    for centers in vocab.centers:
        cen = centers.reshape(-1, k, 256)
        node = node * k + _assign(desc, cen, node)
    return node


def l1_score(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity: s = 1 - 0.5 |v1 - v2|_1 (vectors L1-normalized).

    (reference: Thirdparty/DBoW2 ScoringObject.cpp L1Scoring)
    Batched over leading dims of v1.
    """
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)


def transform_sparse(vocab: Vocabulary, desc: jnp.ndarray,
                     valid: jnp.ndarray, top_w: int):
    """[F, 256] descriptors -> word-sparse BoW: (word [W] i32, wt [W] f32).

    The L1-normalized tf-idf vector of a keyframe has at most F nonzeros,
    so a (word-id, weight) pair list of capacity `top_w` represents it
    exactly (or keeps the heaviest words when the bank has more distinct
    words than slots). This is the storage DBoW2's inverted file implies —
    per-image word lists — without the dense [K, n_words] matrix the
    dense path materializes (reference:
    src/KeyFrameDatabase.cc:581 inverted-file scoring).

    Padding: unused slots carry wt = 0 (word id 0), which contributes
    nothing to the min-intersection score.
    """
    node = jnp.zeros((desc.shape[0],), jnp.int32)
    k = vocab.k
    for centers in vocab.centers:
        cen = centers.reshape(-1, k, 256)
        node = node * k + _assign(desc, cen, node)
    w = vocab.n_words
    tf = jnp.zeros((w,), jnp.float32).at[node].add(
        valid.astype(jnp.float32))
    v = tf * vocab.idf
    v = v / jnp.maximum(jnp.sum(v), 1e-9)
    eff = min(top_w, w)       # tiny vocabularies: fewer words than slots
    wt, word = jax.lax.top_k(v, eff)
    if eff < top_w:
        pad = top_w - eff
        word = jnp.concatenate([word, jnp.zeros((pad,), word.dtype)])
        wt = jnp.concatenate([wt, jnp.zeros((pad,), wt.dtype)])
    return word.astype(jnp.int32), jnp.maximum(wt, 0.0)


def save(path: str, vocab: Vocabulary) -> str:
    """Persist a trained vocabulary (npz) with a content hash.

    The reference ships a pre-trained 1M-word ORBvoc and binds loaded
    maps to it by MD5 (System.cc:1520-1556 ComputeMD5 of the vocabulary
    file); here the hash is stored inside the file and returned so
    callers can bind artifacts the same way. Returns the hex digest.
    """
    import hashlib

    arrays = {f"centers_{i}": np.asarray(c)
              for i, c in enumerate(vocab.centers)}
    arrays["idf"] = np.asarray(vocab.idf)
    blob = b"".join(a.tobytes() for a in arrays.values())
    digest = hashlib.md5(blob).hexdigest()
    np.savez_compressed(path, k=np.asarray(vocab.k),
                        levels=np.asarray(len(vocab.centers)),
                        md5=np.asarray(digest), **arrays)
    return digest


def load(path: str) -> tuple:
    """Load a persisted vocabulary. Returns (Vocabulary, md5 hex digest);
    raises ValueError if the stored hash does not match the content
    (the reference refuses a map whose vocabulary checksum differs).

    `.txt` paths are parsed as the DBoW2 text format (the stock ORBvoc.txt
    the reference loads at startup, include/ORBVocabulary.h:9 +
    TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338); the returned md5
    is of the raw file, matching System::Shutdown's checksum binding
    (src/System.cc:1520-1556)."""
    import hashlib

    if str(path).endswith(".txt"):
        with open(path, "rb") as f:
            digest = hashlib.md5(f.read()).hexdigest()
        return load_dbow2_text(path), digest

    with np.load(path) as data:
        levels = int(data["levels"])
        centers = tuple(jnp.asarray(data[f"centers_{i}"])
                        for i in range(levels))
        idf = jnp.asarray(data["idf"])
        k = int(data["k"])
        stored = str(data["md5"])
        blob = b"".join(np.asarray(data[f"centers_{i}"]).tobytes()
                        for i in range(levels))
        blob += np.asarray(data["idf"]).tobytes()
    digest = hashlib.md5(blob).hexdigest()
    if digest != stored:
        raise ValueError(f"vocabulary {path}: content hash {digest} != "
                         f"stored {stored} (corrupt or tampered file)")
    return Vocabulary(centers=centers, idf=idf, k=k), digest


def load_dbow2_text(path: str) -> Vocabulary:
    """Parse a DBoW2 text vocabulary (the ORBvoc.txt format) into the
    dense-array Vocabulary.

    Format (reference: TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338): the first line is
    `k L scoring_type weight_type`; every following line is one node —
    `parent_id is_leaf b0 .. b31 weight` with the 256-bit descriptor as 32
    bytes. Node ids are implicit (root = 0, then file order); children
    keep file order under their parent; words are the leaf nodes.

    Idiom shift: DBoW2 walks a pointer tree; here every level becomes a
    dense [k^(l+1), 256] center table and descent is a batched Hamming
    argmin (see `transform`). DBoW2 trees are INCOMPLETE — nodes may have
    fewer than k children, and leaves occur above the last level — which
    the dense layout absorbs exactly:

    * a missing child slot copies the FIRST child's center — `argmin`
      breaks ties toward the lower index, so a padded slot never wins;
    * a leaf above the bottom level continues as a degenerate chain (all
      child slots carry the leaf's own center), so descent deterministically
      reaches a unique bottom-level node, which receives the word weight.

    Both give bit-exact descent parity with DBoW2's child-argmin walk.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leafs, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leafs.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))
    n_nodes = len(parents)
    bytes_arr = np.asarray(descs, np.uint8)               # [N, 32]
    bits = np.unpackbits(bytes_arr, axis=1, bitorder="little")  # [N, 256]
    bits = bits.astype(np.int8)

    # children of each node, in file order (node ids: 1..N after root 0)
    children: list[list[int]] = [[] for _ in range(n_nodes + 1)]
    for i, p in enumerate(parents):
        children[p].append(i + 1)

    centers = [np.zeros((k ** (lv + 1), 256), np.int8)
               for lv in range(L)]
    idf = np.zeros((k ** L,), np.float32)

    # BFS with dense positions; entries: (node_id or None for a leaf
    # chain, dense_pos, level, chain_center, chain_weight)
    frontier = [(0, 0)]
    chain: list[tuple] = []      # (dense_pos, center_bits, weight)
    for lv in range(L):
        next_frontier = []
        next_chain = []
        for pos, bits_c, w in chain:
            centers[lv][pos * k] = bits_c
            for s in range(1, k):
                centers[lv][pos * k + s] = bits_c
            if lv == L - 1:
                idf[pos * k] = w
            else:
                next_chain.append((pos * k, bits_c, w))
        for node, pos in frontier:
            ch = children[node]
            if not ch:
                continue
            first_bits = bits[ch[0] - 1]
            for s in range(k):
                if s < len(ch):
                    c = ch[s]
                    cb = bits[c - 1]
                    centers[lv][pos * k + s] = cb
                    is_leaf = leafs[c - 1] or not children[c]
                    if is_leaf:
                        if lv == L - 1:
                            idf[pos * k + s] = weights[c - 1]
                        else:
                            next_chain.append((pos * k + s, cb,
                                               weights[c - 1]))
                    else:
                        next_frontier.append((c, pos * k + s))
                else:
                    # pad: copy of first child (argmin tie -> slot 0)
                    centers[lv][pos * k + s] = first_bits
        frontier = next_frontier
        chain = next_chain

    return Vocabulary(
        centers=tuple(jnp.asarray(c) for c in centers),
        idf=jnp.asarray(idf), k=k)


def save_dbow2_text(path: str, vocab: Vocabulary) -> None:
    """Write a trained (complete-tree) Vocabulary in the DBoW2 text
    format, byte-layout compatible with `load_dbow2_text` /
    TemplatedVocabulary::loadFromTextFile (leaves at the bottom level
    carry the idf weights; internal weights are 0)."""
    k = vocab.k
    L = len(vocab.centers)
    idf = np.asarray(vocab.idf)
    lines = [f"{k} {L} 0 0"]
    # node ids: root 0; level-l nodes appended in dense order — a node at
    # level l, dense pos p has id  offset(l) + p  with
    # offset(l) = 1 + k + ... + k^l   (geometric prefix, root excluded)
    offsets = [1]
    for lv in range(1, L):
        offsets.append(offsets[-1] + k ** lv)

    for lv, cen in enumerate(vocab.centers):
        cen_np = np.asarray(cen, np.int8)
        packed = np.packbits(cen_np.astype(np.uint8), axis=1,
                             bitorder="little")            # [n, 32]
        n = cen_np.shape[0]
        for p in range(n):
            parent = 0 if lv == 0 else offsets[lv - 1] + p // k
            is_leaf = 1 if lv == L - 1 else 0
            w = float(idf[p]) if is_leaf else 0.0
            byte_str = " ".join(str(int(b)) for b in packed[p])
            lines.append(f"{parent} {is_leaf} {byte_str} {w}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def l1_score_sparse(word_a, wt_a, word_b, wt_b, n_words: int):
    """L1 similarity between two word-sparse BoW vectors.

    For L1-normalized nonnegative vectors, 1 - 0.5|u - v|_1 reduces to the
    min-intersection  sum_w min(u_w, v_w)  over shared words.
    """
    dense_a = jnp.zeros((n_words,), wt_a.dtype).at[word_a].max(wt_a)
    return jnp.sum(jnp.minimum(wt_b, dense_a[word_b]))
