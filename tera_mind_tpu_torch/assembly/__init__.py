from .wsi import WsiWriter, assemble_slice, ome_xml

__all__ = ["WsiWriter", "assemble_slice", "ome_xml"]
