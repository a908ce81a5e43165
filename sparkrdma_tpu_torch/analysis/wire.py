"""Pass 1 — wire-protocol checker.

The control plane's correctness lives in client-side protocol discipline
(one-sided design: no server handler validates a request shape twice).
This pass machine-checks that discipline:

* **registry** — every ``WIRE_IDS`` row registered, ids unique, and the
  id space DENSE over 1..max except the ids pinned (with a reason) in
  ``RESERVED_WIRE_IDS`` — a typo'd or recycled wire number cannot land.
* **round-trip** — fuzzed ``payload()``/``from_payload()`` parity per
  message class: decode(encode(m)) must re-encode byte-identically, so
  a field a packer writes but the unpacker drops (or vice versa) fails
  here instead of in a mixed-version cluster.
* **truncation** — the legacy decode matrix: payloads truncated at every
  historical format boundary (fence-less publishes, lengths-less
  publishes, epoch-less table responses) must still decode to the
  documented defaults.
* **native constants** — parses ``csrc/*.cpp`` for every ``constexpr``
  constant and checks each against its declared Python mirror
  (generalizing the old single-constant grep test); a NEW native
  constant that is neither mirrored nor explicitly ignored is itself a
  finding, so triage can't be skipped.
* **doc table** — the message-ID table in docs/CONFIG.md is generated
  from the registry; committed text must match the generator.
"""

from __future__ import annotations

import inspect
import os
import random
import re
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from sparkrdma_tpu_torch.analysis.core import Finding, rel, repo_root
from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel import rpc_msg
from sparkrdma_tpu_torch.utils.ids import ExecutorId, ShuffleManagerId

PASS = "wire"


def _anchor(cls) -> Tuple[str, int]:
    """(path, line) of a message class definition, for findings."""
    try:
        path = inspect.getsourcefile(cls) or "<unknown>"
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        path, line = "<unknown>", 0
    return path, line


def _finding(root: str, cls, message: str) -> Finding:
    path, line = _anchor(cls)
    return Finding(PASS, rel(root, path), line, message)


# ---------------------------------------------------------------- registry

def check_registry(pairs: Sequence[Tuple[int, type]],
                   wire_ids: Optional[Dict[str, int]] = None,
                   reserved: Optional[Dict[int, str]] = None,
                   root: Optional[str] = None) -> List[Finding]:
    """Id uniqueness + density + table/registry agreement.

    ``pairs`` is ``[(msg_type, cls), ...]`` — a list, not a dict, so
    fixture files can seed duplicate ids.
    """
    root = root or repo_root()
    wire_ids = rpc_msg.WIRE_IDS if wire_ids is None else wire_ids
    reserved = rpc_msg.RESERVED_WIRE_IDS if reserved is None else reserved
    findings: List[Finding] = []

    seen: Dict[int, type] = {}
    for msg_type, cls in pairs:
        if msg_type in seen:
            findings.append(_finding(
                root, cls,
                f"duplicate wire id {msg_type}: {cls.__name__} collides "
                f"with {seen[msg_type].__name__}"))
            continue
        seen[msg_type] = cls
        expected = wire_ids.get(cls.__name__)
        if expected is None:
            findings.append(_finding(
                root, cls,
                f"{cls.__name__} registered with id {msg_type} but has "
                f"no WIRE_IDS row"))
        elif expected != msg_type:
            findings.append(_finding(
                root, cls,
                f"{cls.__name__} registered as {msg_type} but WIRE_IDS "
                f"says {expected}"))
        if getattr(cls, "MSG_TYPE", None) != msg_type:
            findings.append(_finding(
                root, cls,
                f"{cls.__name__}.MSG_TYPE={getattr(cls, 'MSG_TYPE', None)}"
                f" != registered id {msg_type}"))

    for name, msg_type in wire_ids.items():
        if msg_type not in seen:
            findings.append(Finding(
                PASS, "sparkrdma_tpu_torch/parallel/rpc_msg.py", 0,
                f"WIRE_IDS row {name}={msg_type} has no registered class"))

    if seen:
        lo, hi = 1, max(max(seen), max(wire_ids.values(), default=1))
        for i in range(lo, hi + 1):
            if i in seen and i in reserved:
                findings.append(_finding(
                    root, seen[i],
                    f"wire id {i} is RESERVED ({reserved[i]}) but "
                    f"{seen[i].__name__} uses it"))
            elif i not in seen and i not in reserved:
                findings.append(Finding(
                    PASS, "sparkrdma_tpu_torch/parallel/rpc_msg.py", 0,
                    f"wire id space has an unexplained hole at {i}: "
                    f"register it or pin it in RESERVED_WIRE_IDS with a "
                    f"reason"))
    return findings


def live_pairs() -> List[Tuple[int, type]]:
    return sorted(rpc_msg.registry().items())


# ------------------------------------------------------------- round-trip

def _mk_manager_id(rng: random.Random) -> ShuffleManagerId:
    i = rng.randrange(1 << 8)
    return ShuffleManagerId(
        ExecutorId(str(i), f"host{i}.example", 7000 + i),
        f"host{i}.example", 9000 + i, rng.randrange(1 << 16))


def _gen_arg(name: str, rng: random.Random):
    """Generate one constructor argument by parameter-name convention.

    The conventions are the codebase's own: ``req_id``/``epoch``/
    ``fence`` are i64-ish, ``entry`` is the 12-byte driver-table entry,
    ``blocks`` the (buf, offset, length) scatter list, etc. A NEW
    message class whose parameter names fall outside the table fails
    loudly (None -> TypeError inside the fuzz loop), which is the
    desired "teach the fuzzer about your field" nudge.
    """
    if name in ("req_id", "fence", "bcast_id", "consumed", "owner_gen"):
        return rng.randrange(1 << 62)
    if name == "seq":
        # per-shard op-log sequence: u64 pack, fuzz the width
        return rng.randrange(1 << 63)
    if name == "blobs":
        # ShardBatchMsg merged-blob riders: length-prefixed opaque bytes
        return [bytes(rng.randrange(256) for _ in range(rng.randrange(32)))
                for _ in range(rng.randrange(3))]
    if name == "epoch":
        # non-negative only: AnnounceMsg's broadcast epoch packs u64.
        # The signed location-plane epochs get EPOCH_DEAD coverage from
        # _EXTRA_CASES below.
        return rng.choice([0, 1, rng.randrange(1 << 40)])
    if name == "entry":
        return bytes(rng.randrange(256) for _ in range(M.PublishMsg.ENTRY_BYTES))
    if name == "table":
        # driver-table bytes: always whole 12-byte MAP_ENTRY_SIZE entries
        # (FetchTableResp's legacy-epoch disambiguation depends on it)
        return bytes(rng.randrange(256)
                     for _ in range(M.PublishMsg.ENTRY_BYTES
                                    * rng.randrange(6)))
    if name in ("data", "plan_bytes", "entries", "payload", "accepted",
                "covered"):
        return bytes(rng.randrange(256) for _ in range(4 * rng.randrange(17)))
    if name == "blocks":
        return [(rng.randrange(1 << 32), rng.randrange(1 << 48),
                 rng.randrange(1 << 31)) for _ in range(rng.randrange(5))]
    if name == "sizes":
        # per-partition byte lengths of a push (u32 each, never None)
        return [rng.randrange(1 << 31) for _ in range(rng.randrange(6))]
    if name == "ranges":
        # (offset: u64, length: u32) byte ranges of a merged segment
        return [(rng.randrange(1 << 48), rng.randrange(1 << 31))
                for _ in range(rng.randrange(4))]
    if name == "records":
        return [(rng.randrange(1 << 20), rng.randrange(6),
                 bytes(rng.randrange(256) for _ in range(16 * rng.randrange(4))))
                for _ in range(rng.randrange(4))]
    if name in ("map_ids", "shard_slots"):
        return [rng.randrange(1 << 20) for _ in range(rng.randrange(6))]
    if name == "slot_states":
        # membership slot states pack one BYTE each (SLOT_LIVE=0 /
        # SLOT_DRAINING=1 / SLOT_DEAD=2); fuzz the full byte domain so
        # a future state value can't silently truncate
        return [rng.randrange(256) for _ in range(rng.randrange(8))]
    if name == "lengths":
        return rng.choice([None,
                           [rng.randrange(1 << 31)
                            for _ in range(rng.randrange(8))]])
    if name == "blob":
        # HA frames: op payload / snapshot envelope — opaque bytes
        return bytes(rng.randrange(256) for _ in range(rng.randrange(64)))
    if name == "blob_key":
        # cold-tier object keys: "<sid>/p<p>/<name>" path shapes, utf-8
        # (including multi-byte chars — the length prefix counts BYTES)
        return "/".join(
            "".join(rng.choice("seg_dra0briefn\u00e9") for _ in
                    range(rng.randrange(1, 10)))
            for _ in range(rng.randrange(1, 4)))
    if name == "nbytes":
        # u64 blob sizes: object stores hold blobs past any i32 file
        # domain; the max-u64 boundary rides _EXTRA_CASES too
        return rng.choice([0, rng.randrange(1 << 31),
                           rng.randrange(1 << 63)])
    if name in ("name", "host"):
        # lease-holder identity / standby address host
        return "".join(rng.choice("abc-xyz.0123") for _ in
                       range(rng.randrange(1, 16)))
    if name == "manager_id":
        return _mk_manager_id(rng)
    if name == "manager_ids":
        return [_mk_manager_id(rng) for _ in range(rng.randrange(4))]
    if name in ("flags", "status"):
        return rng.randrange(8)
    return rng.randrange(1 << 20)  # generic i32-ish field


def _build(cls: type, rng: random.Random):
    sig = inspect.signature(cls.__init__)
    kwargs = {}
    for pname, param in list(sig.parameters.items())[1:]:  # skip self
        if param.kind in (inspect.Parameter.VAR_POSITIONAL,
                          inspect.Parameter.VAR_KEYWORD):
            continue
        kwargs[pname] = _gen_arg(pname, rng)
    return cls(**kwargs)


# Hand-built instances covering domain corners the name-based generator
# deliberately avoids (signed location epochs carry EPOCH_DEAD; the
# driver answers dead shuffles with num_published=-1).
_EXTRA_CASES: Dict[str, List[Callable[[], "rpc_msg.RpcMsg"]]] = {
    "EpochBumpMsg": [lambda: M.EpochBumpMsg(5, M.EPOCH_DEAD)],
    "FetchTableResp": [lambda: M.FetchTableResp(1, -1, b"", M.EPOCH_DEAD)],
    "FetchShardResp": [lambda: M.FetchShardResp(1, -1, M.EPOCH_DEAD, b"")],
    "FetchMergedResp": [
        lambda: M.FetchMergedResp(1, M.STATUS_UNKNOWN_SHUFFLE,
                                  M.EPOCH_DEAD, b"")],
    # elastic membership corners: an empty fleet's bump, the three real
    # slot states together, and a failed drain's error response — plus
    # the membership-epoch DOMAIN corners for msgs 36-39 (epoch 0, which
    # a live driver never pushes but a mixed-version peer may replay;
    # max-i64, the signed-pack boundary; an all-DRAINING state vector,
    # the whole-fleet-decommission edge nothing on a healthy cluster
    # ever emits)
    "MembershipBumpMsg": [
        lambda: M.MembershipBumpMsg(1, []),
        lambda: M.MembershipBumpMsg(7, [0, 1, 2, 0]),
        lambda: M.MembershipBumpMsg(0, [1]),
        lambda: M.MembershipBumpMsg((1 << 63) - 1, [1, 1, 1, 1])],
    "JoinMsg": [
        lambda: M.JoinMsg(_mk_manager_id(random.Random(7)),
                          flags=(1 << 32) - 1)],
    "DrainReq": [
        lambda: M.DrainReq(1, 0, 0),
        lambda: M.DrainReq((1 << 62) - 1, 0, (1 << 63) - 1)],
    "DrainResp": [
        lambda: M.DrainResp(3, M.STATUS_ERROR, 0, 0),
        lambda: M.DrainResp(1, M.STATUS_OK, (1 << 63) - 1,
                            (1 << 63) - 1)],
    # planned-push corners: plan epoch 0 (the identity plan — a sender
    # that pushed before any broadcast landed), max-i64 plan epoch and
    # attempt fence together (both ride signed <q packs), a zero-size
    # range entry inside a run (empty partition still holds its slot in
    # the accept vector), and an all-rejected verdict
    "PushPlannedReq": [
        lambda: M.PushPlannedReq(1, 2, 3, 0, 0, 0, [], b""),
        lambda: M.PushPlannedReq(1, 2, 3, (1 << 63) - 1, (1 << 63) - 1,
                                 5, [4, 0, 8], b"x" * 12)],
    "PushPlannedResp": [
        lambda: M.PushPlannedResp(1, M.STATUS_UNKNOWN_SHUFFLE, b""),
        lambda: M.PushPlannedResp(1, M.STATUS_OK, b"\x00\x00\x00")],
    # driver-HA corners (msgs 42-45): the incarnation-0 identity stamps
    # a pre-failover log writes, max-u32 incarnation + max-u64 seq (the
    # unsigned pack boundaries), an empty op/snapshot blob, an
    # empty-name standby hello (a misconfigured holder id must still
    # round-trip, the lease CAS rejects it later), and a takeover
    # re-pointing to a long hostname
    "OpLogAppendMsg": [
        lambda: M.OpLogAppendMsg(0, 1, 1, b""),
        lambda: M.OpLogAppendMsg((1 << 32) - 1, (1 << 64) - 1, 8,
                                 b"\x00" * 3)],
    "SnapshotMsg": [
        lambda: M.SnapshotMsg(0, 0, b""),
        lambda: M.SnapshotMsg((1 << 32) - 1, (1 << 64) - 1, b"{}")],
    "StandbyHelloMsg": [
        lambda: M.StandbyHelloMsg("", "", 0, 0),
        lambda: M.StandbyHelloMsg("sb-1", "h" * 200, (1 << 32) - 1,
                                  (1 << 64) - 1)],
    "TakeoverMsg": [
        lambda: M.TakeoverMsg(0, "127.0.0.1", 1),
        lambda: M.TakeoverMsg((1 << 32) - 1, "x" * 128, (1 << 32) - 1)],
    # partitioned-ownership corners (msgs 46-50): generation 0 (a
    # pre-assignment straggler the owner bounces as STALE_GEN) and
    # max-i64 generation (the composed-epoch signed-pack boundary);
    # a length-less publish vs a histogram-bearing one; an empty
    # convergence batch (gen-change flush of an untouched shard) and a
    # mixed records+blobs batch; an empty op blob; and the handoff
    # old_slot=-1 sentinel (shard count grew — no predecessor to seal)
    "ShardPublishMsg": [
        lambda: M.ShardPublishMsg(1, 0, b"\x00" * 12, 0, 0, None),
        lambda: M.ShardPublishMsg(1, 2, b"\xff" * 12, (1 << 62) - 1,
                                  (1 << 63) - 1, [0, 7, 1 << 30])],
    "ShardMergedPublishMsg": [
        lambda: M.ShardMergedPublishMsg(1, 0, 0, b""),
        lambda: M.ShardMergedPublishMsg(1, 3, (1 << 63) - 1, b"m" * 64)],
    "ShardBatchMsg": [
        lambda: M.ShardBatchMsg(1, 0, 0, [], []),
        lambda: M.ShardBatchMsg(1, 1, (1 << 63) - 1,
                                [(0, 0, b"\x00" * 12, None),
                                 (5, 9, b"\x01" * 12, [1, 2, 3])],
                                [b"", b"blob"])],
    "ShardOpMsg": [
        lambda: M.ShardOpMsg(1, 0, 0, 0, 1, b""),
        lambda: M.ShardOpMsg(1, 2, (1 << 63) - 1, (1 << 64) - 1, 2,
                             b"\x7f" * 40)],
    "ShardHandoffMsg": [
        lambda: M.ShardHandoffMsg(1, 0, 1, 2, -1),
        lambda: M.ShardHandoffMsg(1, 3, (1 << 63) - 1, 0, 5)],
    # cold-tier corners (msgs 51-53): an EMPTY covered bitmap with an
    # empty key (a degenerate publish must round-trip, the driver
    # rejects it later), max-u64 blob size + max-u32 CRC together (the
    # unsigned pack boundaries), and the dead-shuffle directory answer
    # (STATUS_UNKNOWN_SHUFFLE + EPOCH_DEAD + empty bytes) the reducer's
    # last resolve rung must decode without a directory present
    "TieredPublishMsg": [
        lambda: M.TieredPublishMsg(1, 0, "", 0, 0, b""),
        lambda: M.TieredPublishMsg(1, 3, "9/p3/seg_2_41",
                                   (1 << 64) - 1, (1 << 32) - 1,
                                   b"\x07\x00\x00\x00")],
    "FetchTieredResp": [
        lambda: M.FetchTieredResp(1, M.STATUS_UNKNOWN_SHUFFLE,
                                  M.EPOCH_DEAD, b""),
        lambda: M.FetchTieredResp((1 << 62) - 1, M.STATUS_OK,
                                  (1 << 62) - 1, b"\x00" * 21)],
}


def fuzz_roundtrip(pairs: Sequence[Tuple[int, type]], trials: int = 8,
                   seed: int = 0, root: Optional[str] = None
                   ) -> List[Finding]:
    """decode(encode(m)) must RE-ENCODE byte-identically for every
    registered class: asymmetric pack/unpack (field written but not
    read, wrong offset, dropped trailer) shows up as a payload diff."""
    root = root or repo_root()
    findings: List[Finding] = []
    for msg_type, cls in pairs:
        extras = _EXTRA_CASES.get(cls.__name__, [])
        for t in range(trials + len(extras)):
            rng = random.Random(seed * 1_000_003 + msg_type * 131 + t)
            try:
                msg = (_build(cls, rng) if t < trials
                       else extras[t - trials]())
                p1 = msg.payload()
                p2 = cls.from_payload(p1).payload()
            except Exception as e:  # noqa: BLE001 — any crash is a finding
                findings.append(_finding(
                    root, cls,
                    f"{cls.__name__} round-trip crashed (trial {t}): "
                    f"{type(e).__name__}: {e}"))
                break
            if p1 != p2:
                findings.append(_finding(
                    root, cls,
                    f"{cls.__name__} pack/unpack asymmetry (trial {t}): "
                    f"re-encoded payload differs at byte "
                    f"{next(i for i in range(min(len(p1), len(p2)) + 1) if i >= min(len(p1), len(p2)) or p1[i] != p2[i])} "
                    f"(len {len(p1)} -> {len(p2)})"))
                break
    return findings


# ------------------------------------------------------------- truncation

def _legacy_cases() -> List[Tuple[type, bytes, Callable, str]]:
    """(cls, legacy_payload, accept(msg) -> bool, description).

    Each case is a payload a PRE-UPGRADE peer actually emitted: the
    format grew by appending, so decoding the historical prefix must
    yield the documented defaults — that is the whole mixed-version
    story, and nothing else checks it.
    """
    entry = bytes(range(M.PublishMsg.ENTRY_BYTES))
    full_pub = M.PublishMsg(7, 3, entry, fence=9,
                            lengths=[1, 2, 3]).payload()
    table = b"\xab" * 24
    cases = [
        (M.PublishMsg, full_pub[:8 + M.PublishMsg.ENTRY_BYTES],
         lambda m: m.fence == 0 and m.lengths is None
         and m.entry == entry and (m.shuffle_id, m.map_id) == (7, 3),
         "fence-less publish (pre-fencing peer) must decode with "
         "fence=0, lengths=None"),
        (M.PublishMsg, full_pub[:8 + M.PublishMsg.ENTRY_BYTES + 8],
         lambda m: m.fence == 9 and m.lengths is None,
         "lengths-less publish (pre-planning peer) must decode with "
         "lengths=None"),
        (M.FetchTableResp,
         struct.pack("<qi", 5, 2) + table,
         lambda m: m.req_id == 5 and m.num_published == 2
         and m.epoch == 0 and m.table == table,
         "epoch-less table response (pre-metadata-plane peer) must "
         "decode with epoch=0"),
        (M.FetchTableResp, struct.pack("<qi", 5, 0),
         lambda m: m.epoch == 0 and m.table == b"",
         "header-only (empty, epoch-less) table response must decode"),
    ]
    # elastic-membership boundaries: a pre-elastic peer's hello payload
    # shape (no flags) decoding as a JoinMsg, an epoch-only membership
    # bump (no state vector = every announced slot LIVE), and a
    # deadline-less drain request (receiver's configured default)
    mid = M.JoinMsg(_mk_manager_id(random.Random(0))).payload()
    cases += [
        (M.JoinMsg, mid[:-4],
         lambda m: m.flags == 0,
         "flag-less join (a hello-shaped pre-elastic payload) must "
         "decode with flags=0"),
        (M.MembershipBumpMsg, struct.pack("<q", 11),
         lambda m: m.epoch == 11 and m.slot_states == [],
         "epoch-only membership bump (pre-elastic peer) must decode "
         "with an empty state vector (= all slots LIVE)"),
        (M.DrainReq, struct.pack("<qi", 4, 2),
         lambda m: m.req_id == 4 and m.slot == 2 and m.deadline_ms == 0,
         "deadline-less drain request must decode with deadline_ms=0 "
         "(= the receiver's drain_deadline_ms)"),
    ]
    return cases


def check_truncation(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    for cls, payload, accept, desc in _legacy_cases():
        try:
            msg = cls.from_payload(payload)
        except Exception as e:  # noqa: BLE001 — decode crash is the finding
            findings.append(_finding(
                root, cls, f"{desc}; decode raised "
                f"{type(e).__name__}: {e}"))
            continue
        if not accept(msg):
            findings.append(_finding(
                root, cls, f"{desc}; decoded fields are wrong"))
    return findings


# ------------------------------------------------------- native constants

# constexpr <type> <name> = <expr>;  — the tiny expression grammar csrc
# actually uses: "<int>[u|ul|ull] [<< <int>]".
_CONSTEXPR_RE = re.compile(
    r"^\s*constexpr\s+[\w:<>]+\s+(k\w+)\s*=\s*([^;]+);", re.MULTILINE)
_EXPR_RE = re.compile(
    r"^\s*(\d+)\s*(?:u|ul|ull)?\s*(?:<<\s*(\d+))?\s*$")


def parse_native_constants(cpp_text: str) -> Dict[str, Tuple[int, int]]:
    """name -> (value, line) for every integer ``constexpr k...``."""
    out: Dict[str, Tuple[int, int]] = {}
    for m in _CONSTEXPR_RE.finditer(cpp_text):
        name, expr = m.group(1), m.group(2).strip()
        em = _EXPR_RE.match(expr)
        if not em:
            continue  # non-integer constexpr: out of scope
        value = int(em.group(1)) << (int(em.group(2)) if em.group(2) else 0)
        line = cpp_text.count("\n", 0, m.start()) + 1
        out[name] = (value, line)
    return out


# The mirror spec: every protocol-visible native constant and the Python
# value it must equal. ``IGNORED`` = server-internal tuning with no
# Python mirror, pinned here so the coverage rule stays exhaustive.
def _mirror_spec() -> Dict[str, Dict[str, Callable[[], int]]]:
    return {
        "blockserver.cpp": {
            "kReqType": lambda: M.FetchBlocksReq.MSG_TYPE,
            "kRespType": lambda: M.FetchBlocksResp.MSG_TYPE,
            "kStatusOk": lambda: M.STATUS_OK,
            "kStatusUnknown": lambda: M.STATUS_UNKNOWN_SHUFFLE,
            "kStatusBadRange": lambda: M.STATUS_BAD_RANGE,
            "kStatusError": lambda: M.STATUS_ERROR,
            "kMaxReqFrame": lambda: M.NATIVE_MAX_REQ_FRAME,
            "kFlagCrc32": lambda: M.FLAG_CRC32,
        },
        # The native CLIENT speaks the same wire dialect the server does;
        # both sides' constants pin to the one Python definition so a
        # protocol change that edits only one .cpp file fails here.
        "fetchclient.cpp": {
            "kReqType": lambda: M.FetchBlocksReq.MSG_TYPE,
            "kRespType": lambda: M.FetchBlocksResp.MSG_TYPE,
            "kStatusOk": lambda: M.STATUS_OK,
            "kFlagCrc32": lambda: M.FLAG_CRC32,
            "kMaxReqFrame": lambda: M.NATIVE_MAX_REQ_FRAME,
            "kReqFixedBytes": lambda: M.BLOCKS_REQ_FIXED_BYTES,
            "kRespFixedBytes": lambda: M.BLOCKS_RESP_FIXED_BYTES,
            "kBlockWireBytes": lambda: M.BLOCK_WIRE_BYTES,
        },
    }


_IGNORED_NATIVE = {
    "blockserver.cpp": {
        "kMaxRespPayload",  # server-side response cap; clients discover
                            # it as kStatusBadRange, never plan against it
        "kOutHighWater",    # per-connection outbound buffering threshold
        "kInHighWater",     # inbound buffering threshold
        "kMaxIov",          # iovec batch per sendmsg flush, never on the
                            # wire (IOV_MAX-bounded server tuning)
        "kMaxPendingPerConn",  # fair-share deferred-request cap per
                               # connection; pure server memory tuning,
                               # clients just see backpressure
    },
    "arena.cpp": {
        "kMaxRegion",       # allocator carve-region size, never on the wire
    },
    "fetchclient.cpp": {
        "kMaxRespPayload",  # client-side sanity cap on one response frame;
                            # pure defense, the server never hits it
        "kMaxSendIov",      # writev batch per doorbell flush, never on the
                            # wire (IOV_MAX-bounded client tuning)
        "kMaxPendingPerConn",  # in-flight request cap per connection;
                               # client memory tuning only
    },
    "staging.cpp": set(),
    "writer.cpp": set(),
}


def check_native_constants(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    findings: List[Finding] = []
    spec = _mirror_spec()
    csrc = os.path.join(root, "csrc")
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cpp"):
            continue
        path = os.path.join(csrc, fname)
        with open(path) as f:
            constants = parse_native_constants(f.read())
        mirrors = spec.get(fname, {})
        ignored = _IGNORED_NATIVE.get(fname, set())
        relpath = rel(root, path)
        for name, (value, line) in sorted(constants.items()):
            if name in mirrors:
                expected = mirrors[name]()
                if value != expected:
                    findings.append(Finding(
                        PASS, relpath, line,
                        f"native constant {name}={value} drifted from "
                        f"its Python mirror ({expected})"))
            elif name not in ignored:
                findings.append(Finding(
                    PASS, relpath, line,
                    f"unclassified native constant {name}: add it to "
                    f"the mirror spec or the ignore list in "
                    f"analysis/wire.py"))
        for name in sorted(set(mirrors) - set(constants)):
            findings.append(Finding(
                PASS, relpath, 0,
                f"mirror spec expects {name} in {fname} but it is gone"))

    # Frame-geometry invariants the C++ request parser hardcodes:
    # [total:4][type:4][req_id:8][shuffle:4][count:4][(buf:4,off:8,len:4)*].
    if M.BLOCKS_REQ_FIXED_BYTES != 24:
        findings.append(Finding(
            PASS, "sparkrdma_tpu_torch/parallel/messages.py", 0,
            f"BLOCKS_REQ_FIXED_BYTES={M.BLOCKS_REQ_FIXED_BYTES} no longer "
            f"matches the native frame layout (req_id:8 + shuffle:4 + "
            f"count:4 + header:8 = 24)"))
    if M.BLOCK_WIRE_BYTES != 16:
        findings.append(Finding(
            PASS, "sparkrdma_tpu_torch/parallel/messages.py", 0,
            f"BLOCK_WIRE_BYTES={M.BLOCK_WIRE_BYTES} != the native "
            f"16-byte (buf:u32, offset:u64, length:u32) range"))
    return findings


# --------------------------------------------------------------- doc table

DOC_BEGIN = "<!-- analysis:wire-ids:begin -->"
DOC_END = "<!-- analysis:wire-ids:end -->"


def render_msg_id_table() -> str:
    """The docs/CONFIG.md message-ID table, generated from the registry
    (run ``python -m sparkrdma_tpu_torch.analysis --write-docs`` to refresh)."""
    rows = ["| ID | Message | Defined in |", "|---|---|---|"]
    by_id = dict(rpc_msg.registry())
    hi = max(list(by_id) + list(rpc_msg.RESERVED_WIRE_IDS))
    for i in range(1, hi + 1):
        if i in by_id:
            cls = by_id[i]
            mod = cls.__module__.rsplit(".", 1)[-1]
            rows.append(f"| {i} | `{cls.__name__}` | `parallel/{mod}.py` |")
        elif i in rpc_msg.RESERVED_WIRE_IDS:
            rows.append(f"| {i} | *reserved* — "
                        f"{rpc_msg.RESERVED_WIRE_IDS[i]} | |")
        else:
            rows.append(f"| {i} | **UNASSIGNED HOLE** | |")
    return "\n".join(rows)


def check_doc_table(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    doc = os.path.join(root, "docs", "CONFIG.md")
    relpath = rel(root, doc)
    with open(doc) as f:
        text = f.read()
    if DOC_BEGIN not in text or DOC_END not in text:
        return [Finding(PASS, relpath, 0,
                        f"docs/CONFIG.md is missing the generated "
                        f"message-ID table markers {DOC_BEGIN}/{DOC_END}")]
    committed = text.split(DOC_BEGIN, 1)[1].split(DOC_END, 1)[0].strip()
    generated = render_msg_id_table().strip()
    if committed != generated:
        line = text[:text.index(DOC_BEGIN)].count("\n") + 1
        return [Finding(PASS, relpath, line,
                        "committed message-ID table drifted from the "
                        "registry: run `python -m sparkrdma_tpu_torch.analysis "
                        "--write-docs`")]
    return []


def write_doc_table(root: Optional[str] = None) -> str:
    """Regenerate the committed table in place; returns the doc path."""
    root = root or repo_root()
    doc = os.path.join(root, "docs", "CONFIG.md")
    with open(doc) as f:
        text = f.read()
    head, rest = text.split(DOC_BEGIN, 1)
    _, tail = rest.split(DOC_END, 1)
    with open(doc, "w") as f:
        f.write(head + DOC_BEGIN + "\n" + render_msg_id_table()
                + "\n" + DOC_END + tail)
    return doc


def run(root: Optional[str] = None) -> List[Finding]:
    root = root or repo_root()
    pairs = live_pairs()
    findings = check_registry(pairs, root=root)
    findings += fuzz_roundtrip(pairs, root=root)
    findings += check_truncation(root=root)
    findings += check_native_constants(root=root)
    findings += check_doc_table(root=root)
    return findings
