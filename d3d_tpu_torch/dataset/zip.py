"""Selective-parse ZipFile for fast random access inside large archives
(port of ``d3d_tpu.dataset.zip``, stdlib only).

Opening a stock ZipFile parses every central-directory record; for archives
with hundreds of thousands of members (KITTI raw, nuScenes dumps) that
dominates read latency. ``PatchedZipFile`` is told up front which members
will be read and materializes ZipInfo entries only for those, skipping
everything else with two seeks per record and stopping early once all
requested members are found. (Same idea as the reference's patched zipfile,
d3d/dataset/zip.py:19-125, itself based on ThomasPinna's zipfile
improvement; reimplemented against the stdlib internals.)
"""

import io
import struct
from binascii import crc32
from zipfile import (  # noqa: F401
    BadZipFile, ZipFile, ZipInfo, ZIP_STORED, MAX_EXTRACT_VERSION,
    _EndRecData, sizeCentralDir, sizeEndCentDir64, sizeEndCentDir64Locator,
    stringCentralDir, stringEndArchive64, structCentralDir,
    _CD_COMMENT_LENGTH, _CD_EXTRA_FIELD_LENGTH, _CD_FILENAME_LENGTH,
    _CD_LOCAL_HEADER_OFFSET, _CD_SIGNATURE, _ECD_COMMENT, _ECD_LOCATION,
    _ECD_OFFSET, _ECD_SIGNATURE, _ECD_SIZE,
)

__all__ = ["PatchedZipFile"]


def _decode_name(raw, flags):
    # general-purpose bit 11: UTF-8 names; otherwise cp437 per appnote
    return raw.decode("utf-8" if flags & 0x800 else "cp437")


class PatchedZipFile(ZipFile):
    """ZipFile that only parses central-directory entries for the requested
    members.

    :param to_extract: member path(s) that will be read from this archive;
        any other member is invisible to this instance
    """

    def __init__(self, file, mode="r", compression=ZIP_STORED,
                 allowZip64=True, to_extract=()):
        if not isinstance(to_extract, (list, tuple, set)):
            to_extract = [to_extract]
        self.to_extract = set(str(p) for p in to_extract)
        super().__init__(file=file, mode=mode, compression=compression,
                         allowZip64=allowZip64)

    def _RealGetContents(self):
        fp = self.fp
        try:
            endrec = _EndRecData(fp)
        except OSError:
            raise BadZipFile("File is not a zip file")
        if not endrec:
            raise BadZipFile("File is not a zip file")

        size_cd = endrec[_ECD_SIZE]
        offset_cd = endrec[_ECD_OFFSET]
        self._comment = endrec[_ECD_COMMENT]

        # account for data prepended before the archive (and zip64 locators)
        concat = endrec[_ECD_LOCATION] - size_cd - offset_cd
        if endrec[_ECD_SIGNATURE] == stringEndArchive64:
            concat -= sizeEndCentDir64 + sizeEndCentDir64Locator

        self.start_dir = offset_cd + concat
        fp.seek(self.start_dir, 0)
        cd = io.BytesIO(fp.read(size_cd))

        wanted = set(self.to_extract)
        read = 0
        while read < size_cd and wanted:
            raw = cd.read(sizeCentralDir)
            if len(raw) != sizeCentralDir:
                raise BadZipFile(
                    "Truncated central directory (are all requested members "
                    "present in the archive?)")
            rec = struct.unpack(structCentralDir, raw)
            if rec[_CD_SIGNATURE] != stringCentralDir:
                raise BadZipFile("Bad magic number for central directory")

            raw_name = cd.read(rec[_CD_FILENAME_LENGTH])
            name = _decode_name(raw_name, rec[5])
            read += (sizeCentralDir + rec[_CD_FILENAME_LENGTH]
                     + rec[_CD_EXTRA_FIELD_LENGTH] + rec[_CD_COMMENT_LENGTH])

            if name not in wanted:
                cd.seek(rec[_CD_EXTRA_FIELD_LENGTH]
                        + rec[_CD_COMMENT_LENGTH], 1)
                continue
            wanted.remove(name)

            info = ZipInfo(name)
            info.extra = cd.read(rec[_CD_EXTRA_FIELD_LENGTH])
            info.comment = cd.read(rec[_CD_COMMENT_LENGTH])
            (info.create_version, info.create_system, info.extract_version,
             info.reserved, info.flag_bits, info.compress_type, t, d,
             info.CRC, info.compress_size, info.file_size) = rec[1:12]
            if info.extract_version > MAX_EXTRACT_VERSION:
                raise NotImplementedError(
                    "zip file version %.1f" % (info.extract_version / 10))
            info.volume, info.internal_attr, info.external_attr = rec[15:18]
            info._raw_time = t
            info.date_time = ((d >> 9) + 1980, (d >> 5) & 0xF, d & 0x1F,
                              t >> 11, (t >> 5) & 0x3F, (t & 0x1F) * 2)
            try:
                info._decodeExtra(crc32(raw_name))  # py3.12+ signature
            except TypeError:
                info._decodeExtra()  # py3.10/3.11 take no argument
            info.header_offset = rec[_CD_LOCAL_HEADER_OFFSET] + concat

            self.filelist.append(info)
            self.NameToInfo[info.filename] = info
