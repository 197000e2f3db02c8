"""The ``pandaseq`` command-line interface, flag-compatible with the
reference (args.c, args_fastq.c, args_assembler.c).

Flags: -6 -a -A -B -C -d -D -f -F -g -G -h -i -j -k -l -L -N -o -O -p -q
-r -t -T -u -U -v -w -W   (pandaseq.1)

The pipeline built from argv mirrors panda_parse_args (args.c:420-599):
writer -> logger -> opener -> (async reader) -> assembler -> options ->
fail handler, then the pool loop (pool.c) — here the batch engine over
the device pipeline.
"""

from __future__ import annotations

import bz2 as bz2_mod
import getopt
import math
import os
import sys
import time

import numpy as np

from .. import filters, oracle, stats
from .. import seqid as seqid_mod
from ..assembler import BatchAssembler
from ..io import fastq as fq
from ..io import output as out_mod
from ..nt import nt_from_ascii, nt_from_ascii_complement

VERSION = "pandaseq_tpu 1.0 (pandaseq 2.11 compatible)"
MAX_LEN = 450

# flag -> takes_argument (merged general+fastq+assembler tweak tables)
_OPTSTRING = "6aA:BC:d:D:f:Fg:G:hi:jk:l:L:No:O:p:q:r:t:T:u:U:vw:W:"


class ArgsError(Exception):
    pass


def _safe_int(arg):
    try:
        return int(arg, 10)
    except ValueError:
        return None


def _err(msg):
    sys.stderr.write(msg + "\n")


def show_help(logger, prog="pandaseq"):
    """Auto help (args.c:203-274): usage line, flag help, algorithm and
    module listings."""
    _err("%s <%s>" % (VERSION, "pandaseq_tpu"))
    usage = ("Usage: %s -f forward.fastq -r reverse.fastq "
             "[-6] [-a] [-A algorithm:parameters] [-B] [-C module1 -C "
             "module2 ...] [-d flags] [-D threshold] [-F] [-g log.txt | "
             "-G log.txt.bz2] [-h] [-i index.fastq] [-k kmers] [-l length] "
             "[-L length] [-N] [-o length] [-O length] [-p primer] "
             "[-q primer] [-t threshold] [-T threads] [-u unaligned.txt | "
             "-U unaligned.txt] [-v] [-w output.fasta | -W "
             "output.fasta.bz2]" % prog)
    _err(usage)
    for line in [
        "\t-6\tUse PHRED+64 (CASAVA 1.3-1.7) instead of PHRED+33 "
        "(CASAVA 1.8+).",
        "\t-a\tStrip the primers after assembly, rather than before.",
        "\t-A algorithm:parameters\tThe algorithm to use for assembly.",
        "\t-B\tAllow unbarcoded sequences (try this for BADID errors).",
        "\t-C module\tLoad a pluggable filter module.",
        "\t-d flags\tControl the logging messages. Capital to enable; "
        "small to disable.",
        "\t-D threshold\tPenalise primers if the further they are from "
        "the start of the sequence.",
        "\t-f forward.fastq\tInput FASTQ file containing forward reads.",
        "\t-F\tOutput FASTQ instead of FASTA.",
        "\t-g log.txt\tOutput log to a text file.",
        "\t-G log.txt.bz2\tOutput log to a BZip2-compressed text file.",
        "\t-h\tShow this delightful nonsense.",
        "\t-i index.fastq\tInput FASTQ file containing separate "
        "barcode/index reads.",
        "\t-j\tInput files are bzipped. (Deprecated.)",
        "\t-k kmers\tThe number of k-mers in the table.",
        "\t-l length\tMinimum length for a sequence.",
        "\t-L length\tMaximum length for a sequence.",
        "\t-N\tEliminate all sequences with unknown nucleotides in the "
        "output.",
        "\t-o length\tMinumum overlap region length for a sequence.",
        "\t-O length\tMaximum overlap region length for a sequence. "
        "(0 to use read length.)",
        "\t-p primer\tForward primer sequence or number of bases to be "
        "removed.",
        "\t-q primer\tReverse primer sequence or number of bases to be "
        "removed.",
        "\t-t threshold\tThe minimum probability that a sequence must "
        "have to assemble and, if used, match a primer.",
        "\t-T threads\tRun with a number of parallel threads.",
        "\t-u unaligned.txt\tFile to write unalignable read pairs.",
        "\t-U unaligned.txt\tFile to write unalignable read pairs with "
        "quality scores.",
        "\t-v\tShow version and exit.",
        "\t-w output.fasta\tOutput seqences to a FASTA (or FASTQ) file.",
        "\t-W output.fasta.bz2\tOutput seqences to a BZip2-compressed "
        "FASTA (or FASTQ) file.",
    ]:
        _err(line)
    from .. import algorithms
    _err("Available algorithms:")
    for name in algorithms.list_algorithms():
        _err("\t%s" % name)
    _err("Available modules:")
    filters.show_all(logger)


def _parse_primer(argument: str, direction: str, complement: bool):
    """set_primer (args_assembler.c:177-213): a number means trim-count,
    otherwise a primer sequence."""
    try:
        offset = int(argument, 10)
        is_num = True
    except ValueError:
        is_num = False
    if not is_num:
        conv = nt_from_ascii_complement if complement else nt_from_ascii
        codes = conv(np.frombuffer(argument.encode(), dtype=np.uint8))
        if np.any(codes == 0):
            _err("ERR\tBADNT\t%cPRIMER" % direction[0].upper())
            raise ArgsError("primer")
        return None, codes
    if offset < 1 or offset > MAX_LEN:
        _err("Bad %s primer length." % direction)
        raise ArgsError("primer")
    return offset, None


class Config:
    def __init__(self):
        self.cfg = oracle.OracleConfig()
        self.modules = []
        self.qualmin = 33
        self.policy = seqid_mod.TAG_PRESENT
        self.fwd_file = None
        self.rev_file = None
        self.index_file = None
        self.fastq_out = False
        self.out_path = None
        self.out_bz2 = False
        self.log_path = None
        self.log_bz2 = False
        self.fail_path = None
        self.fail_qual = False
        self.threads = None
        self.debug_flags = stats.DEBUG_DEFAULT
        self.minlen = None
        self.maxlen = None
        # 8192-pair batches x dispatch group 4 = 32768 pairs per device
        # call, amortizing the wire's fixed per-dispatch floor; override
        # via PANDASEQ_TPU_BATCH (the device step scales monotonically
        # in B; decode ring memory scales with it, ~0.6 GB at 8192)
        self.batch = int(os.environ.get("PANDASEQ_TPU_BATCH", "8192"))


def parse_args(argv, prog="pandaseq"):
    """Returns (Config, logger) or raises ArgsError/SystemExit."""
    c = Config()
    module_specs = []
    try:
        opts, rest = getopt.getopt(argv, _OPTSTRING)
    except getopt.GetoptError as e:
        _err(str(e))
        raise ArgsError("getopt")
    if rest:
        _err("Unknown argument: %s" % rest[0])
        raise ArgsError("extra")
    seen = set()
    for flag, arg in opts:
        f = flag[1]
        if f in seen and f not in ("C",):  # repeats rejected (args.c:93)
            _err("The argument -%c may only be specified once." % f)
            raise ArgsError("repeat")
        seen.add(f)
        if f == "6":
            c.qualmin = 64
        elif f == "a":
            c.cfg.post_primers = True
        elif f == "A":
            from .. import algorithms
            name, _, algo_arg = arg.partition(":")
            try:
                c.cfg.algorithm = algorithms.make_algorithm(
                    name, algo_arg or None)
            except (KeyError, ValueError) as e:
                _err("Unknown algorithm: %s" % name
                     if isinstance(e, KeyError) else str(e))
                raise ArgsError("algorithm")
        elif f == "B":
            c.policy = seqid_mod.TAG_OPTIONAL
        elif f == "C":
            module_specs.append(("C", arg))
        elif f == "d":
            c.debug_flags = stats.parse_debug_flags(arg, c.debug_flags)
        elif f == "D":
            try:
                v = float(arg)
            except ValueError:
                v = -1
            if v < 0:
                _err("Bad threshold: %s. It should be between 0 and 1."
                     % arg)
                raise ArgsError("penalty")
            c.cfg.primer_penalty = v
        elif f == "f":
            c.fwd_file = arg
        elif f == "F":
            c.fastq_out = True
        elif f == "g":
            c.log_path, c.log_bz2 = arg, False
        elif f == "G":
            c.log_path, c.log_bz2 = arg, True
        elif f == "h":
            logger = stats.LogProxy()
            show_help(logger, prog)
            raise SystemExit(1)
        elif f == "i":
            c.index_file = arg
        elif f == "j":
            _err("-j option is no longer necessary. Compression is "
                 "auto-detected.")
        elif f == "k":
            try:
                v = int(arg)
            except ValueError:
                v = -1
            if v < 0 or v > 127:
                _err("Bad k-mer list length.")
                raise ArgsError("kmers")
            c.cfg.num_kmers = v
        elif f == "l":
            v = _safe_int(arg)
            if v is None or v < 0 or v > 2 * MAX_LEN:
                _err("Bad minimum length.")
                raise ArgsError("minlen")
            module_specs.append(("l", v))
        elif f == "L":
            v = _safe_int(arg)
            if v is None or v < 1 or v > 2 * MAX_LEN:
                _err("Bad maximum length.")
                raise ArgsError("maxlen")
            module_specs.append(("L", v))
        elif f == "N":
            module_specs.append(("N", None))
        elif f == "o":
            v = _safe_int(arg)
            if v is None or v < 1 or v > 2 * MAX_LEN:
                _err("Bad overlap length.")
                raise ArgsError("minoverlap")
            # the args layer accepts [1, 900] but the setter silently
            # ignores anything outside (1, 900) — so -o 1 and -o 900
            # leave the default of 2 (assembler_support.c:276-282)
            if v > 1 and v < 2 * MAX_LEN:
                c.cfg.minoverlap = v
        elif f == "O":
            v = _safe_int(arg)
            if v is None or v < 0 or v > 2 * MAX_LEN:
                _err("Bad overlap length.")
                raise ArgsError("maxoverlap")
            # setter guard is < 2*MAX_LEN, so -O 900 is silently
            # ignored (assembler_support.c:289-295)
            if v < 2 * MAX_LEN:
                c.cfg.maxoverlap = v
        elif f == "p":
            trim, codes = _parse_primer(arg, "forward", complement=False)
            if codes is not None:
                # set_forward_primer ignores length >= MAX_LEN
                # (assembler_support.c:203-213)
                if len(codes) < MAX_LEN:
                    c.cfg.forward_primer = codes
            else:
                c.cfg.forward_trim = trim
        elif f == "q":
            trim, codes = _parse_primer(arg, "reverse", complement=True)
            if codes is not None:
                if len(codes) < MAX_LEN:
                    c.cfg.reverse_primer = codes
            else:
                c.cfg.reverse_trim = trim
        elif f == "r":
            c.rev_file = arg
        elif f == "t":
            try:
                v = float(arg)
            except ValueError:
                v = -1
            if v < 0 or v > 1:
                _err("Bad threshold: %s. It should be between 0 and 1."
                     % arg)
                raise ArgsError("threshold")
            c.cfg.threshold = math.log(v)
        elif f == "T":
            v = _safe_int(arg)
            if v is None or v < 1:
                _err("Bad number of threads.")
                raise ArgsError("threads")
            c.threads = v
        elif f == "u":
            c.fail_path, c.fail_qual = arg, False
        elif f == "U":
            c.fail_path, c.fail_qual = arg, True
        elif f == "v":
            _err(VERSION)
            raise SystemExit(1)
        elif f == "w":
            c.out_path, c.out_bz2 = arg, False
        elif f == "W":
            c.out_path, c.out_bz2 = arg, True

    c.module_specs = module_specs
    return c


def _open_out(path, use_bz2):
    if path is None or path == "-":
        return sys.stdout.buffer, False
    if use_bz2:
        return bz2_mod.open(path, "wb"), True
    return open(path, "wb"), True


def run(c: Config, argv, prog="pandaseq", reader_wrapper=None,
        batch_wrapper=None) -> int:
    log_stream, close_log = _open_out(c.log_path, c.log_bz2) \
        if c.log_path else (sys.stderr.buffer, False)
    logger = stats.LogProxy(log_stream, c.debug_flags)

    # instantiate modules in argv order (the reference attaches each at
    # its flag's dispatch position, args.c:57-199)
    try:
        for kind, arg in c.module_specs:
            if kind == "C":
                c.modules.append(filters.load_module(arg, logger))
            elif kind == "N":
                c.modules.append(filters.degenerates_module())
            elif kind == "l":
                c.modules.append(filters.short_module(arg))
            elif kind == "L":
                c.modules.append(filters.long_module(arg))
    except filters.ModuleError:
        return 1

    if c.fwd_file is None or c.rev_file is None:
        logger.write_str("You must supply both forward and reverse reads.")
        _err("Too confused to continue.\nTry -h for help.")
        return 1

    out_stream, close_out = _open_out(c.out_path, c.out_bz2)
    fail_stream = None
    if c.fail_path:
        fail_stream = open(c.fail_path, "wb")

    logger.write_str("INFO\tVER\t%s" % VERSION)
    try:
        import platform
        u = platform.uname()
        logger.write_str("INFO\tUNAME\t%s %s %s %s"
                         % (u.system, u.release, u.version, u.machine))
    except Exception:
        pass
    for i, a in enumerate([prog] + list(argv)):
        logger.write_str("ARG[%d]\t%s" % (i, a))

    threads = c.threads if c.threads else 1
    logger.stat("THREADS", threads)

    fmt = out_mod.format_fastq if c.fastq_out else out_mod.format_fasta
    fail_fmt = out_mod.format_fail_qual if c.fail_qual \
        else out_mod.format_fail

    from ..runtime import enable_compilation_cache, maybe_profile
    enable_compilation_cache()
    prof = maybe_profile().__enter__()  # PANDASEQ_TPU_PROFILE=<dir>
    asm = BatchAssembler(c.cfg, L=512, modules=c.modules)
    # provenance: which candidate-search engine serves this run (the
    # measured auto default, or a pin) — args.c:515-531 analogue. The
    # auto probe resolves here, before the first batch dispatches.
    try:
        eng = asm.engine
        info = asm.engine_info or {}
        logger.write_str("INFO\tENGINE\t%s (%s)"
                         % (eng, info.get("reason", "auto")))
    except Exception:
        pass
    reporter = stats.StatReporter(logger)

    native_reader = None
    if ((reader_wrapper is None or batch_wrapper is not None)
            and not os.environ.get("PANDASEQ_TPU_NO_NATIVE")):
        from ..io import native
        try:
            if native.get_lib() is not None:
                # ring: the emit pipeline holds at most depth(6) +
                # prefetch(4) + pre_stream/finalize/consumer (~4)
                # batches; 20 persistent sets removes ~21 MB/batch of
                # first-touch page faults from the decode wall time.
                # The -d K/R/M oracle-replay path may hold pair views
                # longer, so it keeps fresh allocations.
                detail = c.debug_flags & (stats.DEBUG_KMER
                                          | stats.DEBUG_RECON
                                          | stats.DEBUG_MISMATCH)
                # ring must cover prefetch(4+1) + dispatch group +
                # pipeline depth(+1) + finalize futs(~4) in-flight
                # batches (the engine hard-fails on overrun)
                group = int(os.environ.get("PANDASEQ_TPU_GROUP", "4"))
                depth = int(os.environ.get("PANDASEQ_TPU_DEPTH", "10"))
                native_reader = native.NativeBatchReader(
                    c.fwd_file, c.rev_file, qualmin=c.qualmin,
                    policy=c.policy, batch=c.batch, L=512,
                    index_path=c.index_file,
                    ring=0 if detail else depth + group + 14)
        except (OSError, RuntimeError):
            native_reader = None
    if native_reader is None:
        try:
            reader = fq.read_pairs(
                c.fwd_file, c.rev_file, qualmin=c.qualmin, policy=c.policy,
                index=(fq.open_buffer(c.index_file) if c.index_file
                       else None))
        except OSError as e:
            logger.write_str("ERR\tNOFILE\t%s" % e)
            return 1
        if reader_wrapper is not None:
            reader = reader_wrapper(reader, logger)
    else:
        reader = native_reader

    some_seqs = False

    def batches():
        if native_reader is not None:
            if batch_wrapper is not None:
                yield from batch_wrapper(native_reader, logger)
            else:
                yield from native_reader
            if native_reader.error and native_reader.error != "EOF":
                logger.write(native_reader.error, flag=stats.DEBUG_FILE)
            return
        eof = False
        while not eof:
            pairs = []
            while len(pairs) < c.batch:
                try:
                    pairs.append(next(reader))
                except StopIteration:
                    eof = True
                    break
                except fq.StreamError as e:
                    logger.write(e.code, sid=None,
                                 message=e.detail or None,
                                 flag=stats.DEBUG_FILE)
                    eof = True
                    break
            if pairs:
                yield pairs

    from ..io.prefetch import prefetch
    done = 0

    def handle_reject(pair, code, res):
        if code == "LOWQ":
            logger.write("LOWQ", sid=res.sid if res else pair.sid,
                         message="%f < %f"
                         % (math.exp(res.quality),
                            math.exp(c.cfg.threshold)),
                         flag=stats.DEBUG_STAT)
        elif code in ("NOFP", "NORP"):
            logger.write(code, sid=pair.sid, flag=stats.DEBUG_STAT)
        if fail_stream is not None and code == "NOALGN":
            fail_stream.write(fail_fmt(pair))

    log_bestolp = bool(c.debug_flags & stats.DEBUG_BUILD)
    # detailed per-base tracing (-d K/R/M) replays each pair through the
    # exact oracle purely for its log stream (the reference's
    # LOG/LOGV call sites, assembler.c:93-242)
    detail_bits = c.debug_flags & (stats.DEBUG_KMER | stats.DEBUG_RECON
                                   | stats.DEBUG_MISMATCH)
    debug_replay = None
    if detail_bits:
        from .. import oracle as _oracle

        def debug_replay(pair):
            def dbg(bit, code, msg):
                logger.write(code, sid=pair.sid, message=msg, flag=bit)
            _oracle.assemble(c.cfg, pair, dbg=dbg)

    # per-thread STAT emulation (-T N): the reference prints each worker
    # assembler's OWN final counter block (pool.c:83-104); batches are
    # attributed round-robin to N virtual assemblers so the output
    # schema (N blocks whose tallies sum to the totals) is preserved
    # deterministically. Work distribution differs from the pthread
    # pool's (which is scheduling-dependent and nondeterministic).
    from ..assembler import Counters as _Counters
    vcounters = [_Counters() for _ in range(threads)] if threads > 1 \
        else None
    batch_no = 0

    def attribute(vc, delta, hist, n_pairs):
        vc.count += n_pairs
        vc.ok += int(delta[0])
        vc.lowq += int(delta[1])
        vc.noalgn += int(delta[2])
        vc.badread += int(delta[3])
        vc.nofp += int(delta[4])
        vc.norp += int(delta[5])
        vc.slow += int(delta[6])
        if hist is not None:
            for o in np.flatnonzero(hist):
                vc.overlaps[int(o)] = vc.overlaps.get(int(o), 0) \
                    + int(hist[o])

    # the byte-emission fast path also covers filter-module configs
    # when every check-stage module has a vectorized check_batch (all
    # built-ins do); custom python modules fall to the general path
    from ..io import native as _native_mod
    use_emit = (not c.cfg.post_primers and debug_replay is None
                and _native_mod.get_lib() is not None
                and all(m.check is None or m.check_batch is not None
                        for m in c.modules))
    if use_emit:
        emit_fmt = "fastq" if c.fastq_out else "fasta"
        # pre_stream runs the _pre stage (prechecks, primer scans) on
        # the prefetch thread, overlapped with device dispatch; group
        # stacks 4 batches per device call to amortize the wire's
        # fixed per-dispatch floor (grouping is a no-op in host-only
        # mode, where _dispatch_group falls back per batch); depth
        # keeps >= 2*group batches in flight so the wire stays busy
        # between grouped bursts. The decode ring above is sized for
        # these values (PANDASEQ_TPU_GROUP / PANDASEQ_TPU_DEPTH).
        group = int(os.environ.get("PANDASEQ_TPU_GROUP", "4"))
        depth = int(os.environ.get("PANDASEQ_TPU_DEPTH", "10"))
        for pairs, codes, payload, extras in asm.emit_stream(
                prefetch(asm.pre_stream(batches())), fmt=emit_fmt,
                with_extras=True, depth=depth, threaded=True,
                group=group):
            out_stream.write(payload)
            overlaps = extras["overlap"]
            scored = extras["scored"]
            if vcounters is not None and "counters_delta" in extras:
                attribute(vcounters[batch_no % threads],
                          extras["counters_delta"], extras["hist_delta"],
                          len(codes))
            batch_no += 1
            nonok = extras.get("nonok_rows")
            if nonok is not None and not log_bestolp:
                # fast path: touch only rejected rows (OK rows need no
                # per-pair Python objects); the TIME/READS blocks stay
                # interleaved at their exact 1000-read boundaries
                # between reject lines (pool.c:76-80 ordering)
                nb = len(codes)
                if len(nonok) < nb:
                    some_seqs = True
                next_mark = (done // 1000 + 1) * 1000
                for i in nonok:
                    # boundaries of records strictly before this one
                    # print first; a reject ON the boundary record
                    # precedes its own TIME block (the per-record loop
                    # handled the reject before the done%1000 check)
                    while next_mark <= done + i:
                        reporter.print_time(next_mark)
                        next_mark += 1000
                    code, res = codes[i]
                    handle_reject(pairs[i], code, res)
                while next_mark <= done + nb:
                    reporter.print_time(next_mark)
                    next_mark += 1000
                done += nb
            else:
                # BESTOLP logging walks every pair (the reference's
                # default DEBUG_BUILD behavior, assembler.c LOG): build
                # the line bytes straight from the decoder's raw id
                # buffer and write per batch — LogProxy + IdStr per
                # pair measured ~25 us/line, ~2.4 s per 100k pairs
                scored_l = scored.tolist()
                overlaps_l = overlaps.tolist()
                raw_ids = (pairs._b.ids_bytes()
                           if log_bestolp and hasattr(pairs, "_b")
                           else None)
                chunks = []
                lstream = logger.stream

                def flush_chunks():
                    if chunks:
                        lstream.write(b"".join(chunks))
                        chunks.clear()

                for i, (code, res) in enumerate(codes):
                    done += 1
                    if log_bestolp and scored_l[i]:
                        if raw_ids is not None:
                            sid_b = raw_ids[i].tobytes().split(
                                b"\0", 1)[0]
                        else:
                            sid_b = str(pairs[i].sid).encode()
                        chunks.append(b"INFO\tBESTOLP\t%s\t%d\n"
                                      % (sid_b, overlaps_l[i]))
                    if code == "OK":
                        some_seqs = True
                    else:
                        flush_chunks()
                        handle_reject(pairs[i], code, res)
                    if done % 1000 == 0:
                        flush_chunks()
                        reporter.print_time(done)
                flush_chunks()
    else:
        import copy as _copy
        prev_snap = _copy.deepcopy(asm.counters) if vcounters else None
        # the worker-thread finalize overlaps the device pipeline, but
        # per-batch counter snapshots (-T > 1) need the main thread to
        # observe counters between batches -> keep those runs unthreaded
        # keep _pre on the main thread when -T > 1 snapshots counters
        # between batches (prefetched _pre would inflate cur.count)
        stream = prefetch(asm.pre_stream(batches())) \
            if vcounters is None else prefetch(batches())
        for pairs, results in asm.assemble_stream(
                stream, threaded=vcounters is None):
            if vcounters is not None:
                cur, p = asm.counters, prev_snap
                delta = [cur.ok - p.ok, cur.lowq - p.lowq,
                         cur.noalgn - p.noalgn, cur.badread - p.badread,
                         cur.nofp - p.nofp, cur.norp - p.norp,
                         cur.slow - p.slow]
                vc = vcounters[batch_no % threads]
                # READS for THIS batch: counters.count increments at
                # _pre time, which the pipeline runs depth batches
                # ahead — cur.count - p.count would attribute future
                # batches' reads to this thread (and zero to the
                # drain-phase ones)
                attribute(vc, delta, None, len(pairs))
                for o, n in cur.overlaps.items():
                    d = n - p.overlaps.get(o, 0)
                    if d:
                        vc.overlaps[o] = vc.overlaps.get(o, 0) + d
                prev_snap = _copy.deepcopy(cur)
            batch_no += 1
            for pair, (code, res) in zip(pairs, results):
                done += 1
                if debug_replay is not None:
                    debug_replay(pair)
                elif log_bestolp and res is not None and \
                        getattr(res, "overlap", 0):
                    logger.write("BESTOLP", sid=pair.sid,
                                 message=str(res.overlap))
                if code == "OK":
                    out_stream.write(fmt(res))
                    some_seqs = True
                else:
                    handle_reject(pair, code, res)
                if done % 1000 == 0:
                    reporter.print_time(done)

    if reader.seen_under_64 is False and reader.non_empty \
            and c.qualmin == 33:
        logger.write("PHRED_OFFSET")  # fastq.c:195-207
    if vcounters is not None and sum(v.count for v in vcounters) \
            == asm.counters.count:
        # one final block per virtual assembler thread (pool.c:83-104);
        # module reject tallies are global, printed with thread 0
        for t, vc in enumerate(vcounters):
            reporter.final(
                vc, modules=c.modules if t == 0 else (),
                has_fwd_primer=c.cfg.forward_primer is not None,
                has_rev_primer=c.cfg.reverse_primer is not None)
    else:
        reporter.final(asm.counters, modules=c.modules,
                       has_fwd_primer=c.cfg.forward_primer is not None,
                       has_rev_primer=c.cfg.reverse_primer is not None)
    for mod in c.modules:
        if mod.destroy is not None:
            mod.destroy()

    prof.__exit__()
    if close_out:
        out_stream.close()
    if fail_stream is not None:
        fail_stream.close()
    if close_log:
        log_stream.close()
    return 0 if some_seqs else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        c = parse_args(argv)
    except ArgsError:
        _err("Too confused to continue.\nTry -h for help.")
        return 1
    except SystemExit as e:
        return int(e.code or 0)
    return run(c, argv)


if __name__ == "__main__":
    sys.exit(main())
